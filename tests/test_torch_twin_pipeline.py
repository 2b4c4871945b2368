"""Discrete-event pipeline executor: invariants and Fig. 2 scheme sanity."""

import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core.costs import LinkProfile
from repro_torch.core.pipeline import (PipelineResult, TaskPlan,
                                 bandwidth_step_trace, run_pipeline)


def _plan(e, t, c, **kw):
    return TaskPlan(e, t, c, **kw)


@given(st.lists(st.tuples(st.floats(0.001, 0.1), st.floats(0.0, 0.1),
                          st.floats(0.001, 0.1)), min_size=1, max_size=40),
       st.floats(0.0, 0.05))
@settings(max_examples=40, deadline=None)
def test_pipeline_invariants(stages, period):
    plans = [_plan(e, t, c) for (e, t, c) in stages]
    r = run_pipeline(plans, arrival_period=period)
    # per-task latency >= own stage sum
    for rec, p in zip(r.tasks, plans):
        assert rec.latency >= p.t_end + p.t_tx + p.t_cloud - 1e-9
    # makespan >= busy time of any single resource
    assert r.makespan >= r.end_busy - 1e-9
    assert r.makespan >= r.link_busy - 1e-9
    assert r.makespan >= r.cloud_busy - 1e-9
    # throughput bounded by the busiest resource's total work
    busiest = max(sum(p.t_end for p in plans), sum(p.t_tx for p in plans),
                  sum(p.t_cloud for p in plans))
    assert r.throughput <= len(plans) / busiest + 1e-6


def test_fig2_scheme1_vs_scheme2():
    """Scheme 1: stages (1,1,4) latency-min but max stage 4.  Scheme 2:
    (3,1,3) latency 7 but max stage 3 -> higher throughput (25% gain)."""
    n = 50
    s1 = run_pipeline([_plan(1, 1, 4)] * n, arrival_period=2.0)
    s2 = run_pipeline([_plan(3, 1, 3)] * n, arrival_period=2.0)
    assert s2.throughput > s1.throughput
    assert s1.tasks[0].latency < s2.tasks[0].latency  # scheme1 wins 1-task latency
    # paper: max stage 4 -> 3 is ~25% efficiency gain at saturation
    assert s2.throughput / s1.throughput > 1.15


def test_early_exit_skips_link_and_cloud():
    plans = [_plan(1, 5, 5, early_exit=True)] * 10
    r = run_pipeline(plans, arrival_period=1.0)
    assert r.link_busy == 0.0 and r.cloud_busy == 0.0
    assert r.exit_ratio == 1.0
    assert all(math.isclose(t.latency, 1.0) for t in r.tasks)


def test_tx_offset_overlaps_transmission():
    """With tx_offset < t_end the link starts before end-compute finishes
    (Fig. 4 layer-parallel overlap) -> lower latency."""
    no_ov = run_pipeline([_plan(2, 2, 0.1)], arrival_period=0)
    ov = run_pipeline([_plan(2, 2, 0.1, tx_offset=0.5)], arrival_period=0)
    assert ov.tasks[0].latency < no_ov.tasks[0].latency - 0.9


def test_dynamic_bandwidth_trace_slows_tasks():
    trace = bandwidth_step_trace([(0.0, 20.0), (1.0, 5.0)])
    link = LinkProfile("w", 20e6, trace=trace)
    # each task pushes 20e6*0.5 bits = 0.5s at 20Mbps, 2s at 5Mbps
    plans = [_plan(0.1, 0.5, 0.05)] * 8
    r = run_pipeline(plans, arrival_period=0.0, link=link)
    early = r.tasks[0].latency
    late = r.tasks[-1].latency
    assert late > early  # bandwidth drop queues tasks up


def test_bubble_fraction_accounting():
    # unbalanced stages starve the cloud -> large cloud bubbles
    r = run_pipeline([_plan(1.0, 0.1, 0.1)] * 20, arrival_period=0.0)
    assert r.bubble_fraction("cloud") > 0.8
    # balanced stages keep the cloud mostly busy
    r2 = run_pipeline([_plan(0.3, 0.3, 0.3)] * 50, arrival_period=0.0)
    assert r2.bubble_fraction("cloud") < 0.15
