"""Observability layer: span traces, bubble attribution, export, metrics.

Deterministic coverage of the PR's invariants: (1) the differential pin
extends to span timelines — the async executor's trace of a stream
matches the simulator's at 1e-6 across chain / exits / batched / pool /
multi-tenant configs; (2) every idle interval on every resource is
attributed to exactly one cause from the closed enum and the
conservation identity ``busy + sum(bubbles) = horizon`` holds at 1e-9;
(3) each non-trivial cause is *reachable* (a scenario that provably
produces it); (4) the disabled-sink path changes nothing; plus the
``bubble_fraction`` normalization regressions (aggregate ``"link"``
view on multi-hop chains, heterogeneous-speed replica pools).
"""

import json

from repro_torch.core import sim as S
from repro_torch.core.pipeline import TaskPlan, run_pipeline
from repro_torch.core.sim import PoolSpec
from repro_torch.obs.bubbles import CAUSES, attribute, chain_resources
from repro_torch.obs.export import text_summary, to_chrome_trace, write_chrome_trace
from repro_torch.obs.metrics import (MetricsRegistry, populate_from_attribution,
                               populate_from_result, populate_from_trace)
from repro_torch.obs.trace import (SERVICE, Span, TraceRecorder,
                             assert_traces_match, resource_label)
from repro_torch.serving.async_engine import VirtualClock, run_pipeline_async
from repro_torch.serving.routing import make_router
from repro_torch.serving.tenancy import make_policy, run_multitenant_async

CONS_TOL = 1e-9
PIN_TOL = 1e-6


def _traced_pair(plans, arrivals=None, period=0.0, batch_caps=None,
                 pools=None, router_name=None):
    """Run both engines with live recorders; pin the traces; return the
    sim result + its attribution."""
    ts, ta = TraceRecorder(), TraceRecorder()
    r1 = make_router(router_name, seed=1) if router_name else None
    r2 = make_router(router_name, seed=1) if router_name else None
    pr_s = run_pipeline(plans, arrivals=arrivals, arrival_period=period,
                        batch_caps=batch_caps, pools=pools, router=r1,
                        sink=ts)
    pr_a = run_pipeline_async(plans, arrivals=arrivals,
                              arrival_period=period, clock=VirtualClock(),
                              batch_caps=batch_caps, pools=pools,
                              router=r2, sink=ta)
    assert abs(pr_s.makespan - pr_a.makespan) <= PIN_TOL
    assert_traces_match(ts, ta, tol=PIN_TOL)
    att = attribute(ts, resources=chain_resources(
        pr_s.n_hops, pr_s.pool_sizes or None))
    assert att.max_conservation_error() <= CONS_TOL
    assert {b.cause for b in att.bubbles} <= set(CAUSES)
    return pr_s, ts, att


PLANS3 = [TaskPlan.multihop([2.0, 1.0, 3.0], [0.5, 0.7]) for _ in range(6)]


def test_chain_trace_pinned_and_conserving():
    pr, rec, att = _traced_pair(PLANS3, period=1.0)
    # the steady chain exercises the baseline causes
    assert att.total(cause="warmup") > 0
    assert att.total(cause="drain") > 0
    assert att.total(cause="upstream_starvation") > 0
    # unbounded pinned runs never see backpressure (documented invariant)
    assert att.total(cause="downstream_backpressure") == 0.0


def test_exit_cascade_releases_downstream():
    plans = [TaskPlan.multihop([2.0, 1.0, 3.0], [0.5, 0.7],
                               exit_hop=(i % 3 if i % 2 else None))
             for i in range(8)]
    _, _, att = _traced_pair(plans, period=0.8)
    assert att.total(cause="exit_released") > 0


def test_batched_trace_pinned_and_batch_formation():
    plans = [TaskPlan.multihop([0.1, 1.0, 0.1], [0.05, 0.4],
                               t_fixed=[0.0, 0.6, 0.0]) for _ in range(8)]
    _, _, att = _traced_pair(plans, period=0.15, batch_caps=[1, 4, 1])
    assert att.total(cause="batch_formation") > 0


def test_pool_trace_pinned_heterogeneous_speeds():
    pools = [PoolSpec(speeds=(1.0, 2.0)), PoolSpec(speeds=(1.0,)),
             PoolSpec(speeds=(0.5, 1.5, 1.0))]
    pr, rec, att = _traced_pair(PLANS3, period=0.5, pools=pools,
                                router_name="jsq")
    # per-replica accounting: every replica of every tier has a row
    labels = set(att.by_label())
    assert "compute0/r0" in labels and "compute0/r1" in labels
    assert "compute2/r2" in labels and "link0" in labels
    assert len(labels) == (2 + 1 + 3) + 2


def test_sequencer_reorder_reachable():
    # a slow replica's terminal (exit) release blocks the sequencer,
    # holding a later fast-replica task past a link idle gap
    plans = [TaskPlan.multihop([0.2, 0.1], [0.05]),
             TaskPlan.multihop([1.0, 0.1], [0.05], exit_hop=0),
             TaskPlan.multihop([0.2, 0.1], [0.05])]
    _, _, att = _traced_pair(
        plans, arrivals=[0.0, 0.0, 0.0],
        pools=[PoolSpec(speeds=(1.0, 5.0)), PoolSpec(speeds=(1.0,))],
        router_name="jsq")
    assert att.total(cause="sequencer_reorder") > 0


def test_multitenant_trace_pinned():
    mk = [TaskPlan.multihop([1.0, 2.0], [0.4]) for _ in range(4)]
    arr = [[0.0, 0.5, 1.0, 1.5], [0.2, 0.9, 1.6, 2.3]]
    for pol in ("fifo", "wdrr"):
        ts, ta = TraceRecorder(), TraceRecorder()
        ms = S.simulate_multitenant_stream(
            [[p.as_sim_plan(1) for p in mk] for _ in range(2)], arr,
            policy=make_policy(pol), sink=ts)
        ma = run_multitenant_async([list(mk), list(mk)], arr, policy=pol,
                                   clock=VirtualClock(), sink=ta)
        assert ms.order == ma.order
        assert_traces_match(ts, ta, tol=PIN_TOL)
        att = attribute(ts, resources=chain_resources(1))
        assert att.max_conservation_error() <= CONS_TOL


def test_multitenant_pool_ingress_credit_reachable():
    # a slow ingress replica makes admitted tasks wait on credits
    mk = [TaskPlan.multihop([1.0, 0.1], [0.05]) for _ in range(6)]
    pools = [PoolSpec(speeds=(0.2, 1.0)), PoolSpec(speeds=(1.0,))]
    arr = [[0.0] * 6]
    ts, ta = TraceRecorder(), TraceRecorder()
    S.simulate_multitenant_pool_stream(
        [[p.as_sim_plan(1) for p in mk]], arr, policy=make_policy("fifo"),
        pools=pools, router=make_router("jsq", seed=0), sink=ts)
    run_multitenant_async([list(mk)], arr, policy="fifo",
                          clock=VirtualClock(), pools=pools,
                          router=make_router("jsq", seed=0), sink=ta)
    assert_traces_match(ts, ta, tol=PIN_TOL)
    att = attribute(ts, resources=chain_resources(1, [2, 1]))
    assert att.max_conservation_error() <= CONS_TOL
    assert att.total(cause="ingress_credit") > 0


def test_disabled_sink_is_inert():
    pr0 = run_pipeline(PLANS3, arrival_period=1.0)
    rec = TraceRecorder()
    pr1 = run_pipeline(PLANS3, arrival_period=1.0, sink=rec)
    assert pr0.makespan == pr1.makespan
    assert [t.done for t in pr0.tasks] == [t.done for t in pr1.tasks]
    assert len(rec) > 0
    pa0 = run_pipeline_async(PLANS3, arrival_period=1.0,
                             clock=VirtualClock())
    assert abs(pa0.makespan - pr0.makespan) <= PIN_TOL


def test_recorder_accepts_prefix_tuples():
    rec = TraceRecorder()
    rec.span((SERVICE, ("compute", 0, 0), 0.0, 1.0, 7))
    rec.span(Span(SERVICE, ("compute", 0, 0), 1.0, 2.0, task=8,
                  tasks=(8,), ready=0.5, batch=1))
    a, b = rec.spans
    assert isinstance(a, Span) and a.task == 7
    assert a.tasks is None and a.ready is None and a.seq is None
    assert b.ready == 0.5
    # the lazy cache tracks appends after a read
    rec.span((SERVICE, ("link", 0), 2.0, 3.0, 9))
    assert len(rec.spans) == 3 and len(rec) == 3


def test_chrome_trace_structure(tmp_path):
    _, rec, att = _traced_pair(PLANS3, period=1.0)
    doc = to_chrome_trace(rec, att)
    events = doc["traceEvents"]
    names = {e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"compute0/r0", "link0", "compute1/r0", "link1",
            "compute2/r0"} <= names
    busy = [e for e in events if e.get("cat") == "service"]
    assert busy and all(e["ph"] == "X" and e["dur"] >= 0 for e in busy)
    bubbles = [e for e in events if e.get("cat") == "bubble"]
    assert bubbles and {e["name"] for e in bubbles} <= set(CAUSES)
    json.dumps(doc)  # serializable
    out = tmp_path / "trace.json"
    assert write_chrome_trace(out, rec, att) == str(out)
    assert json.loads(out.read_text())["traceEvents"]


def test_text_summary_mentions_every_resource():
    pr, _, att = _traced_pair(PLANS3, period=1.0)
    txt = text_summary(att)
    for res in att.resources():
        assert resource_label(res) in txt
    assert "horizon" in txt


def test_metrics_registry_roundtrip():
    reg = MetricsRegistry()
    reg.inc("a"), reg.inc("a", 2.0)
    reg.set_gauge("g", 0.5)
    for v in (1.0, 3.0, 2.0):
        reg.observe("h", v)
    snap = reg.snapshot()
    assert snap["counters"]["a"] == 3.0
    assert snap["gauges"]["g"] == 0.5
    h = reg.histogram("h")
    assert h["count"] == 3 and h["p50"] == 2.0 and h["max"] == 3.0
    assert "counter a = 3" in reg.render()


def test_metrics_populated_from_run():
    pr, rec, att = _traced_pair(PLANS3, period=1.0)
    reg = MetricsRegistry()
    populate_from_trace(reg, rec)
    populate_from_attribution(reg, att)
    populate_from_result(reg, pr)
    assert reg.counter("tier0.batches") == len(PLANS3)
    assert reg.counter("link0.xfers") == len(PLANS3)
    # busy counters agree with the attribution's busy seconds
    for label, busy in att.busy_by_label().items():
        assert abs(reg.counter(f"busy_s.{label.split('/r')[0]}"
                               if label.startswith("link") else
                               f"busy_s.{label}") - busy) <= 1e-9
    assert reg.gauges["horizon_s"] == att.horizon_s
    assert reg.gauges["makespan_s"] == pr.makespan
    # per-cause bubble seconds sum back to the attribution total
    tot = sum(v for k, v in reg.counters.items()
              if k.startswith("bubble_s."))
    assert abs(tot - att.total()) <= 1e-9


def test_link_bubble_fraction_aggregate_normalization():
    """``bubble_fraction("link")`` on a multi-hop chain: ``link_busy``
    sums every hop, so the capacity must be ``n_hops * makespan``."""
    pr = run_pipeline(PLANS3, arrival_period=1.0)
    assert pr.n_hops == 2
    frac = pr.bubble_fraction("link")
    assert 0.0 <= frac <= 1.0
    expect = 1.0 - pr.link_busy / (pr.n_hops * pr.makespan)
    assert abs(frac - expect) <= 1e-12
    per_hop = [pr.bubble_fraction(("link", k)) for k in range(pr.n_hops)]
    assert all(0.0 <= f <= 1.0 for f in per_hop)


def test_pool_bubble_fraction_heterogeneous_normalization():
    """Replicated-tier normalization: capacity is ``m * makespan`` per
    tier, with *no* speed rescaling (busy time is wall seconds on each
    replica), so heterogeneous pools stay in ``[0, 1]`` and agree with
    the attribution's per-replica busy sums."""
    pools = [PoolSpec(speeds=(1.0, 2.0)), PoolSpec(speeds=(1.0,)),
             PoolSpec(speeds=(0.5, 1.5, 1.0))]
    rec = TraceRecorder()
    pr = run_pipeline(PLANS3, arrival_period=0.5, pools=pools,
                      router=make_router("jsq", seed=1), sink=rec)
    att = attribute(rec, resources=chain_resources(pr.n_hops,
                                                   pr.pool_sizes))
    busy = att.busy_by_label()
    for k, m in enumerate(pr.pool_sizes):
        frac = pr.bubble_fraction(("compute", k))
        assert 0.0 <= frac <= 1.0
        tier_busy = sum(busy[f"compute{k}/r{r}"] for r in range(m))
        assert abs(frac - (1.0 - tier_busy / (m * pr.makespan))) <= 1e-9
    assert 0.0 <= pr.bubble_fraction("end") <= 1.0
    assert 0.0 <= pr.bubble_fraction("cloud") <= 1.0
    assert 0.0 <= pr.bubble_fraction("link") <= 1.0
