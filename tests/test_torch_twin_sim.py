"""Unified N-stage simulator (`repro_torch.core.sim`):

  * parity — the generalized path with one link must reproduce the seed
    3-resource event semantics (StageTimes / PipelineResult) to 1e-9, on
    partitions where each boundary producer feeds a single edge (the one
    regime where the seed's per-producer arrival bookkeeping was correct);
  * regression — a producer feeding several boundary edges gates each
    consumer on the edge it actually consumes (the seed overwrote the
    earlier arrival with the later one);
  * properties — 3-hop bubble accounting: per-resource busy <= makespan,
    latency monotone in added hop time, non-negative bubbles.

Property-style cases are driven by seeded numpy randomness (no hypothesis
dependency: this module must collect everywhere).
"""

import numpy as np
import pytest

from repro_torch.core import sim
from repro_torch.core.costs import (DeviceProfile, LinkProfile, ModelGraph,
                              chain_graph)
from repro_torch.core.pipeline import (PipelineResult, TaskPlan,
                                 bandwidth_step_trace, run_pipeline)
from repro_torch.core.schedule import (PartitionDecision, evaluate_multihop,
                                 evaluate_partition)

END = DeviceProfile("end", 1e9)
CLOUD = DeviceProfile("cloud", 8e9)
EDGE = DeviceProfile("edge", 3e9)
LINK = LinkProfile("link", 100e6)
BACKHAUL = LinkProfile("backhaul", 900e6)


# ------------------------------------------------- seed reference semantics
def seed_evaluate_partition(graph, decision, end_dev, cloud_dev, link,
                            input_bits_per_elem=8):
    """The seed's 3-resource event loop, verbatim (incl. per-producer
    ``recv`` keying) — the parity oracle for the generalized core."""
    end_set = decision.end_set
    t = 0.0
    end_done, end_intervals = {}, []
    for n in graph.nodes:
        if n.id in end_set:
            dt = end_dev.layer_time(n.flops, n.util)
            end_intervals.append((t, t + dt))
            t += dt
            end_done[n.id] = t
    T_e = t

    ready = []
    for (u, v) in graph.boundary_edges(end_set):
        when = 0.0 if u < 0 else end_done[u]
        bits = graph.input_elems * input_bits_per_elem if u < 0 \
            else graph.node(u).out_elems * decision.bits.get((u, v), 32)
        ready.append((when, (u, v), bits))
    ready.sort(key=lambda r: (r[0], r[1]))

    link_free, T_t, first_tx_start = 0.0, 0.0, None
    recv, link_intervals = {}, []
    for (when, (u, v), bits) in ready:
        start = max(when, link_free)
        dur = link.transfer_time(bits, start)
        link_intervals.append((start, start + dur))
        if first_tx_start is None:
            first_tx_start = start
        link_free = start + dur
        T_t += dur
        recv[u] = link_free

    t, T_c = 0.0, 0.0
    cloud_done, cloud_intervals = {}, []
    for n in graph.nodes:
        if n.id in end_set:
            continue
        ready_at = 0.0
        for d in n.deps:
            ready_at = max(ready_at,
                           recv[d] if d in end_set else cloud_done[d])
        if not n.deps:
            ready_at = recv.get(-1, 0.0)
        dt = cloud_dev.layer_time(n.flops, n.util)
        start = max(t, ready_at)
        cloud_intervals.append((start, start + dt))
        t = start + dt
        cloud_done[n.id] = t
        T_c += dt

    finish = max([T_e] + list(cloud_done.values()) + [link_free])
    T_t_par = sim.overlap_total(link_intervals, end_intervals)
    T_c_par = sim.overlap_total(cloud_intervals, link_intervals)
    first_tx = first_tx_start if first_tx_start is not None else T_e
    cloud_first = min((s for s, _ in cloud_intervals), default=first_tx)
    return dict(T_e=T_e, T_t=T_t, T_c=T_c, T_t_par=T_t_par, T_c_par=T_c_par,
                latency=finish, first_tx_offset=first_tx,
                cloud_start_offset=max(0.0, cloud_first - first_tx))


def seed_run_pipeline(plans, arrivals=None, arrival_period=0.0, link=None):
    """The seed's hand-rolled end/link/cloud stream loop, verbatim."""
    n = len(plans)
    if arrivals is None:
        arrivals = [i * arrival_period for i in range(n)]
    end_free = link_free = cloud_free = 0.0
    end_busy = link_busy = cloud_busy = 0.0
    recs = []
    for i, (p, arr) in enumerate(zip(plans, arrivals)):
        e_start = max(arr, end_free)
        e_done = e_start + p.t_end
        end_free = e_done
        end_busy += p.t_end
        if p.early_exit:
            recs.append((i, arr, e_done, e_done - arr, True))
            continue
        tx_ready = e_done if p.tx_offset is None or p.tx_offset >= p.t_end \
            else e_start + p.tx_offset
        t_start = max(tx_ready, link_free)
        t_dur = p.t_tx
        if link is not None and link.trace is not None and p.t_tx > 0:
            bits = p.t_tx * link.bandwidth_bps
            t_dur = link.transfer_time(bits, t_start)
        t_done = t_start + t_dur
        link_free = t_done
        link_busy += t_dur
        c_ready = t_done if p.cloud_offset is None \
            else max(t_start + p.cloud_offset, tx_ready)
        c_start = max(c_ready, cloud_free)
        c_done = max(c_start + p.t_cloud, t_done)
        cloud_free = c_done
        cloud_busy += p.t_cloud
        recs.append((i, arr, c_done, c_done - arr, False))
    makespan = max(r[2] for r in recs) - min(r[1] for r in recs)
    return recs, makespan, end_busy, link_busy, cloud_busy


# ----------------------------------------------------------------- fixtures
def _chain(seed=0, n=10):
    rng = np.random.RandomState(seed)
    flops = rng.uniform(1e6, 5e7, n)
    elems = rng.randint(1_000, 200_000, n)
    return chain_graph(f"chain{seed}", flops, elems)


def _single_edge_cases(graph):
    """(end_set, bits) partitions of a chain: every boundary producer feeds
    exactly one edge, so seed and per-edge arrival semantics agree."""
    n = len(graph)
    cases = []
    for cut in (0, 1, n // 2, n - 1, n):
        end_set = frozenset(range(cut))
        bits = {(cut - 1, cut): 8} if 0 < cut < n else {}
        cases.append((end_set, bits))
    return cases


# ------------------------------------------------------------------- parity
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stage_times_parity_with_seed_semantics(seed):
    g = _chain(seed)
    for end_set, bits in _single_edge_cases(g):
        dec = PartitionDecision(end_set, bits)
        st = evaluate_partition(g, dec, END, CLOUD, LINK)
        ref = seed_evaluate_partition(g, dec, END, CLOUD, LINK)
        for f, want in ref.items():
            assert abs(getattr(st, f) - want) < 1e-9, (f, cut_info(end_set))


def cut_info(end_set):
    return f"|end|={len(end_set)}"


def test_stage_times_parity_under_bandwidth_trace():
    g = _chain(7)
    trace = bandwidth_step_trace([(0.0, 100.0), (0.005, 10.0), (0.02, 60.0)])
    link = LinkProfile("dyn", 100e6, trace=trace)
    for end_set, bits in _single_edge_cases(g):
        dec = PartitionDecision(end_set, bits)
        st = evaluate_partition(g, dec, END, CLOUD, link)
        ref = seed_evaluate_partition(g, dec, END, CLOUD, link)
        for f, want in ref.items():
            assert abs(getattr(st, f) - want) < 1e-9, f


def _random_plans(seed, n=40):
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


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("traced", [False, True])
def test_run_pipeline_parity_with_seed_semantics(seed, traced):
    plans = _random_plans(seed)
    link = None
    if traced:
        link = LinkProfile("dyn", 50e6, trace=bandwidth_step_trace(
            [(0.0, 50.0), (0.03, 8.0), (0.1, 80.0)]))
    pr = run_pipeline(plans, arrival_period=2.5e-3, link=link)
    recs, makespan, e_busy, l_busy, c_busy = seed_run_pipeline(
        plans, arrival_period=2.5e-3, link=link)
    assert abs(pr.makespan - makespan) < 1e-9
    assert abs(pr.end_busy - e_busy) < 1e-9
    assert abs(pr.link_busy - l_busy) < 1e-9
    assert abs(pr.cloud_busy - c_busy) < 1e-9
    for t, (i, arr, done, lat, ee) in zip(pr.tasks, recs):
        assert t.id == i and t.early_exit == ee
        assert abs(t.done - done) < 1e-9
        assert abs(t.latency - lat) < 1e-9


# --------------------------------------------- per-edge arrival regression
def test_per_edge_arrival_not_overwritten():
    """One end producer feeding two boundary edges: the first consumer must
    be gated on *its* transfer, not on the producer's last transfer (the
    seed recorded arrivals per producer and overwrote the earlier one)."""
    from repro_torch.core.costs import LayerNode

    bw = 100e6
    g = ModelGraph("fanout", [
        LayerNode(0, "p", 1e6, 100_000),           # end producer
        LayerNode(1, "c1", 1e6, 1_000, (0,)),       # cloud, cheap transfer
        LayerNode(2, "c2", 1e6, 1_000, (0,)),       # cloud, heavy transfer
    ])
    dec = PartitionDecision(frozenset({0}), {(0, 1): 8, (0, 2): 32})
    st = evaluate_partition(g, dec, END, CLOUD, LinkProfile("l", bw))
    t_p = 1e6 / 1e9                                  # producer compute
    tx1 = 100_000 * 8 / bw                           # edge (0, 1)
    tx2 = 100_000 * 32 / bw                          # edge (0, 2)
    t_c = 1e6 / 8e9                                  # each cloud layer
    # per-edge semantics: c1 starts when ITS edge lands, c2 after both
    want_latency = max(t_p + tx1 + t_c, t_p + tx1 + tx2 + t_c)
    buggy_latency = t_p + tx1 + tx2 + 2 * t_c        # c1 gated on last tx
    assert abs(st.latency - want_latency) < 1e-12
    assert st.latency < buggy_latency - 1e-12


# ------------------------------------------------------- 3-hop properties
def _random_multihop_plans(rng, n, n_hops=2):
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
        plans.append(TaskPlan.multihop(comp, tx, txo, rxo))
    return plans


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_stream_busy_bounded_by_makespan(seed):
    rng = np.random.RandomState(seed)
    plans = _random_multihop_plans(rng, 50)
    pr = run_pipeline(plans, arrival_period=float(rng.uniform(1e-3, 4e-3)))
    assert pr.n_hops == 2
    for k in range(3):
        assert pr.compute_busy[k] <= pr.makespan + 1e-9
        assert 0.0 <= pr.bubble_fraction(("compute", k)) <= 1.0
    for k in range(2):
        assert pr.link_busy_hops[k] <= pr.makespan + 1e-9
        assert 0.0 <= pr.bubble_fraction(("link", k)) <= 1.0
    # causality: the first and last compute stages are serial within a task
    for t, p in zip(pr.tasks, plans):
        floor = p.t_end if p.early_exit \
            else max(p.compute[0], p.compute[-1])
        assert t.latency >= floor - 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_latency_monotone_in_added_hop_time(seed):
    rng = np.random.RandomState(seed)
    plans = _random_multihop_plans(rng, 40)
    base = run_pipeline(plans, arrival_period=2e-3)
    for hop, field in ((0, "tx"), (1, "tx"), (1, "compute")):
        bumped = []
        for p in plans:
            if p.early_exit or not p.compute:
                bumped.append(p)
                continue
            comp, tx = list(p.compute), list(p.tx)
            if field == "tx":
                tx[hop] += 1e-3
            else:
                comp[hop] += 1e-3
            bumped.append(TaskPlan.multihop(comp, tx, p.tx_offsets,
                                            p.rx_offsets))
        pr = run_pipeline(bumped, arrival_period=2e-3)
        assert pr.mean_latency >= base.mean_latency - 1e-12, (hop, field)
        assert pr.makespan >= base.makespan - 1e-12, (hop, field)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multihop_stage_times_properties(seed):
    g = _chain(seed, n=12)
    n = len(g)
    rng = np.random.RandomState(seed + 100)
    for _ in range(5):
        c1, c2 = sorted(rng.choice(range(1, n), size=2, replace=True))
        f1, f2 = frozenset(range(c1)), frozenset(range(c2))
        hop_bits = [{(c1 - 1, c1): 8} if c1 < n else {},
                    {(c2 - 1, c2): 8} if c2 < n else {}]
        dec = PartitionDecision.multihop([f1, f2], hop_bits)
        st = evaluate_multihop(g, dec, (END, EDGE, CLOUD), (LINK, BACKHAUL))
        assert st.n_hops == 2
        assert st.B_c >= 0 and st.B_t >= 0
        assert st.max_stage - 1e-12 <= st.latency <= st.stage_sum + 1e-9
        assert abs(sum(st.compute) -
                   sum(END.layer_time(nd.flops, nd.util) for nd in g.nodes
                       if nd.id < c1) -
                   sum(EDGE.layer_time(nd.flops, nd.util) for nd in g.nodes
                       if c1 <= nd.id < c2) -
                   sum(CLOUD.layer_time(nd.flops, nd.util) for nd in g.nodes
                       if nd.id >= c2)) < 1e-9


def test_empty_middle_segment_matches_two_hop():
    """A 3-hop deployment whose middle tier is empty and whose backhaul is
    effectively infinite must reproduce the 2-hop numbers (relay identity
    of the generalized core)."""
    g = _chain(11)
    n = len(g)
    cut = n // 2
    f = frozenset(range(cut))
    bits = {(cut - 1, cut): 8}
    st2 = evaluate_partition(g, PartitionDecision(f, bits), END, CLOUD, LINK)
    fast = LinkProfile("inf", 1e18)
    dec3 = PartitionDecision.multihop([f, f], [bits, dict(bits)])
    st3 = evaluate_multihop(g, dec3, (END, EDGE, CLOUD), (LINK, fast))
    assert abs(st3.latency - st2.latency) < 1e-6
    assert abs(st3.compute[0] - st2.T_e) < 1e-12
    assert st3.compute[1] == 0.0
    assert abs(st3.compute[-1] - st2.T_c) < 1e-12
    assert abs(st3.link[0] - st2.T_t) < 1e-12
