"""Batched offline-planner scorer (core.plan_fast): differential pin
against the event simulator, sweep-representative equivalence, argmin
equality of the fast planner vs the naive per-candidate simulation
search, and the quantization memoization.

Seeded random series-parallel graphs (no hypothesis dependency: these
run in every environment) exercise virtual blocks, skip edges, relayed
boundary tensors and degenerate (empty-segment) cuts.
"""

import itertools
import math

import numpy as np
import pytest

from repro_torch.core import plan_fast
from repro_torch.core.costs import (DeviceProfile, LinkProfile, LayerNode,
                              ModelGraph, chain_graph)
from repro_torch.core.pipeline import bandwidth_step_trace
from repro_torch.core.partitioner import (QuantCache, _quantize_boundary,
                                    _relax_bits, analytic_acc_loss,
                                    brute_force, chain_flow, chain_prefixes,
                                    coach_offline, coach_offline_multihop,
                                    strided_positions)
from repro_torch.core.schedule import PartitionDecision, evaluate_multihop
from repro_torch.models.cnn import resnet101, vgg16

END = DeviceProfile("end", 1e11)
MID = DeviceProfile("mid", 4e11)
MID2 = DeviceProfile("mid2", 6e11)
CLOUD = DeviceProfile("cloud", 1e12)
L1 = LinkProfile("l1", 50e6)
L2 = LinkProfile("l2", 400e6)
L3 = LinkProfile("l3", 900e6)

DEPLOYMENTS = {
    1: ((END, CLOUD), (L1,)),
    2: ((END, MID, CLOUD), (L1, L2)),
    3: ((END, MID, MID2, CLOUD), (L1, L2, L3)),
}


# --------------------------------------------------------------- generators
def rand_sp_graph(seed: int, n_blocks: int = 3) -> ModelGraph:
    """Random series-parallel DAG: chain runs, 1-3 branch blocks of 1-3
    nodes, optional skip edges — the structures Alg. 1 clusters into
    virtual blocks."""
    rng = np.random.default_rng(seed)
    nodes = []
    nid = 0

    def add(name, deps):
        nonlocal nid
        nodes.append(LayerNode(
            nid, name, float(rng.uniform(1e7, 5e8)),
            int(rng.integers(2_000, 120_000)), tuple(deps),
            sensitivity=float(rng.uniform(0.004, 0.08)),
            util=float(rng.uniform(0.3, 1.0))))
        nid += 1
        return nid - 1

    prev = add("in", ())
    for b in range(n_blocks):
        for _ in range(int(rng.integers(0, 3))):
            prev = add(f"c{nid}", (prev,))
        entry = prev
        tails = []
        for j in range(int(rng.integers(1, 4))):
            cur = entry
            for _ in range(int(rng.integers(1, 4))):
                cur = add(f"b{b}_{j}_{nid}", (cur,))
            tails.append(cur)
        if rng.random() < 0.5:
            tails.append(entry)  # skip edge straight to the join
        prev = add(f"join{b}", tuple(tails))
    add("head", (prev,))
    return ModelGraph(f"sp{seed}", nodes)


def rand_nested_frontiers(rng, graph: ModelGraph, n_hops: int):
    """Random nested downward-closed frontier tuples (not restricted to
    chain prefixes — exercises the general scorer)."""
    def close_down(s):
        s = set(s)
        changed = True
        while changed:
            changed = False
            for i in list(s):
                for d in graph.node(i).deps:
                    if d not in s:
                        s.add(d)
                        changed = True
        return s

    frontiers = []
    cur: set = set()
    for _ in range(n_hops):
        pick = [i for i in range(len(graph)) if rng.random() < 0.4]
        cur = close_down(cur | set(pick)) if rng.random() < 0.8 else set(cur)
        frontiers.append(frozenset(cur))
    return frontiers


def rand_hop_bits(rng, graph: ModelGraph, frontiers):
    """Random explicit bit maps; ~20% of boundary edges omitted to hit
    the simulator's fp32 default pricing."""
    out = []
    for f in frontiers:
        bits = {}
        for (u, v) in graph.boundary_edges(f):
            if u >= 0 and rng.random() < 0.8:
                bits[(u, v)] = int(rng.integers(2, 17))
        out.append(bits)
    return out


def build_tables(graph, devices, links, eps=0.005):
    qc = QuantCache(graph, eps, analytic_acc_loss)
    prefixes = chain_prefixes(graph)
    return plan_fast.build_tables(
        graph, devices, links, qc.node_bits,
        pref_counts=[len(p) for p in prefixes]), qc, prefixes


STAGE_FIELDS = ("compute", "link", "link_par", "compute_par", "tx_offsets",
                "rx_offsets", "latency", "T_e", "T_t", "T_c", "T_t_par",
                "T_c_par", "first_tx_offset", "cloud_start_offset")


def assert_stage_times_close(a, b, rtol=1e-9):
    for f in STAGE_FIELDS:
        va = np.atleast_1d(np.asarray(getattr(a, f), dtype=float))
        vb = np.atleast_1d(np.asarray(getattr(b, f), dtype=float))
        np.testing.assert_allclose(va, vb, rtol=rtol, atol=1e-12,
                                   err_msg=f"field {f}")
    assert math.isclose(a.objective(), b.objective(),
                        rel_tol=rtol, abs_tol=1e-12)
    assert a.satisfies_parallel_constraint() == \
        b.satisfies_parallel_constraint()


# ------------------------------------------------- differential: exactness
@pytest.mark.parametrize("seed", range(6))
def test_chain_scorer_matches_simulator(seed):
    """Fast chain-cut scoring == evaluate_multihop on random SP graphs,
    including repeated positions (empty segments => relayed tensors)."""
    g = rand_sp_graph(seed)
    n_hops = 1 + seed % 3
    devices, links = DEPLOYMENTS[n_hops]
    tables, qc, prefixes = build_tables(g, devices, links)
    rng = np.random.default_rng(seed + 100)
    combos = list(itertools.combinations_with_replacement(
        range(len(prefixes)), n_hops))
    rng.shuffle(combos)
    for combo in combos[:12]:
        for extra in (0, 1, 8):
            frontiers = [frozenset(prefixes[i]) for i in combo]
            hop_bits = [{e: min(16, b + extra)
                         for e, b in qc.boundary_bits(f).items()}
                        for f in frontiers]
            ref = evaluate_multihop(
                g, PartitionDecision.multihop(frontiers, hop_bits),
                devices, links)
            assert_stage_times_close(
                ref, plan_fast.stage_times_chain(tables, combo, extra))
            assert_stage_times_close(
                ref, plan_fast.stage_times_frontiers(
                    tables, frontiers, extra=extra))


@pytest.mark.parametrize("seed", range(6))
def test_frontier_scorer_matches_simulator(seed):
    """General nested-frontier scoring == evaluate_multihop under random
    downward-closed cuts and random (partially missing) bit maps."""
    g = rand_sp_graph(seed, n_blocks=2)
    rng = np.random.default_rng(seed + 500)
    n_hops = 1 + seed % 3
    devices, links = DEPLOYMENTS[n_hops]
    tables, _, _ = build_tables(g, devices, links)
    for _ in range(8):
        frontiers = rand_nested_frontiers(rng, g, n_hops)
        hop_bits = rand_hop_bits(rng, g, frontiers)
        ref = evaluate_multihop(
            g, PartitionDecision.multihop(frontiers, hop_bits),
            devices, links)
        assert_stage_times_close(
            ref, plan_fast.stage_times_frontiers(tables, frontiers,
                                                 hop_bits=hop_bits))


def test_seed_models_scorer_matches_simulator():
    """Spot-check the seed evaluation models (chain + bottleneck DAG)."""
    for g in (vgg16(), resnet101()):
        devices, links = DEPLOYMENTS[2]
        tables, qc, prefixes = build_tables(g, devices, links)
        rng = np.random.default_rng(0)
        combos = list(itertools.combinations_with_replacement(
            range(len(prefixes)), 2))
        rng.shuffle(combos)
        for combo in combos[:15]:
            frontiers = [frozenset(prefixes[i]) for i in combo]
            hop_bits = [dict(qc.boundary_bits(f)) for f in frontiers]
            ref = evaluate_multihop(
                g, PartitionDecision.multihop(frontiers, hop_bits),
                devices, links)
            assert_stage_times_close(
                ref, plan_fast.stage_times_chain(tables, combo, 0))


# ------------------------------------------- sweep representatives + argmin
def test_chain_sweep_matches_naive_relax_representatives():
    """chain_sweep's per-tuple (objective, feasible) representatives ==
    the naive _relax_bits funnel, for every tuple of the sweep (pins the
    vectorized serial path, the lean overlap replay and the level
    pruning)."""
    g = rand_sp_graph(3)
    devices, links = DEPLOYMENTS[2]
    tables, qc, prefixes = build_tables(g, devices, links)
    positions = list(range(len(prefixes)))
    res = plan_fast.chain_sweep(tables, positions, n_hops=2)
    # all non-decreasing pairs minus those whose first frontier is the
    # empty prefix (min_end_nodes=1)
    n_pos = len(positions)
    assert len(res.combos) == n_pos * (n_pos + 1) // 2 - n_pos
    for ti, combo in enumerate(res.combos):
        frontiers = [frozenset(prefixes[i]) for i in combo]
        bits_min = [qc.boundary_bits(f) for f in frontiers]
        (dec, st, obj, feas), _ = _relax_bits(
            g, frontiers, bits_min, devices, links, math.inf)
        assert math.isclose(res.objective[ti], obj, rel_tol=1e-9,
                            abs_tol=1e-12), combo
        assert bool(res.feasible[ti]) == feas, combo


@pytest.mark.parametrize("n_hops", [1, 2, 3])
def test_fast_planner_argmin_equals_naive_vgg(n_hops):
    """Acceptance: the fast planner returns the same PartitionDecision
    and objective (1e-9) as the pre-refactor search on the seed chain
    model at 1/2/3 hops."""
    devices, links = DEPLOYMENTS[n_hops]
    g = vgg16()
    naive = coach_offline_multihop(g, devices, links, fast=False)
    fast = coach_offline_multihop(g, devices, links, fast=True)
    assert fast.decision.cuts == naive.decision.cuts
    assert fast.decision.all_hop_bits == naive.decision.all_hop_bits
    assert math.isclose(fast.objective, naive.objective, rel_tol=1e-9)
    assert fast.feasible == naive.feasible


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_planner_argmin_equals_naive_blocks(seed):
    """Same argmin equality on random block-structured graphs at 2 hops
    (exercises the block-recursion refinement shortlist)."""
    g = rand_sp_graph(seed)
    devices, links = DEPLOYMENTS[2]
    naive = coach_offline_multihop(g, devices, links, fast=False)
    fast = coach_offline_multihop(g, devices, links, fast=True)
    assert fast.decision.cuts == naive.decision.cuts
    assert fast.decision.all_hop_bits == naive.decision.all_hop_bits
    assert math.isclose(fast.objective, naive.objective, rel_tol=1e-9)


def test_fast_planner_argmin_equals_naive_resnet():
    g = resnet101()
    devices, links = DEPLOYMENTS[1]
    naive = coach_offline_multihop(g, devices, links, fast=False)
    fast = coach_offline_multihop(g, devices, links, fast=True)
    assert fast.decision.cuts == naive.decision.cuts
    assert fast.decision.all_hop_bits == naive.decision.all_hop_bits
    assert math.isclose(fast.objective, naive.objective, rel_tol=1e-9)


def test_fast_planner_respects_chain_stride():
    g = vgg16()
    devices, links = DEPLOYMENTS[2]
    naive = coach_offline_multihop(g, devices, links, chain_stride=3,
                                   fast=False)
    fast = coach_offline_multihop(g, devices, links, chain_stride=3,
                                  fast=True)
    assert fast.decision.cuts == naive.decision.cuts
    assert math.isclose(fast.objective, naive.objective, rel_tol=1e-9)
    # the strided grid is the documented subsampling
    positions = strided_positions(len(chain_prefixes(g)), 3)
    assert positions[-1] == len(chain_prefixes(g)) - 1


def test_traced_link_fast_path_small_chain():
    """Links with a bandwidth trace are priced per-candidate by the
    sparse replay (the vectorized closed forms are invalid under
    traces); fast=True must still produce the naive result exactly."""
    g = chain_graph("c", [1e8] * 6, [30_000] * 6)
    trace = LinkProfile("traced", 50e6, trace=lambda t: 50e6)
    naive = coach_offline_multihop(g, (END, CLOUD), (trace,), fast=False)
    fast = coach_offline_multihop(g, (END, CLOUD), (trace,), fast=True)
    assert fast.decision.cuts == naive.decision.cuts
    assert math.isclose(fast.objective, naive.objective, rel_tol=1e-12)


def _step_trace(nominal_bps: float):
    """A genuinely time-varying trace: nominal until 5 ms, then 40%."""
    return bandwidth_step_trace([(0.0, nominal_bps / 1e6),
                                 (0.005, 0.4 * nominal_bps / 1e6)])


@pytest.mark.parametrize("n_hops", [1, 2])
def test_traced_argmin_equals_naive(n_hops):
    """The traced fast funnel (chain_sweep -> frontier_shortlist, every
    candidate scored by exact replay) must return the naive argmin on
    graphs large enough to actually engage it — cuts, bits and
    objective, under a trace that changes rate mid-candidate."""
    g = vgg16()
    devices, links = DEPLOYMENTS[n_hops]
    traced = tuple(LinkProfile(lk.name, lk.bandwidth_bps,
                               trace=_step_trace(lk.bandwidth_bps))
                   for lk in links)
    naive = coach_offline_multihop(g, devices, traced, fast=False)
    fast = coach_offline_multihop(g, devices, traced, fast=True)
    assert fast.decision.cuts == naive.decision.cuts
    assert fast.decision.all_hop_bits == naive.decision.all_hop_bits
    assert math.isclose(fast.objective, naive.objective, rel_tol=1e-9)
    assert fast.feasible == naive.feasible


def test_traced_retimed_tables_warm_start():
    """retime_tables re-links warm tables to new (possibly traced)
    profiles without re-pricing the oracle; planning with them must
    equal a cold run against the same links."""
    g = vgg16()
    devices, links = DEPLOYMENTS[1]
    qc = QuantCache(g, 0.005, analytic_acc_loss)
    tables = plan_fast.build_tables(
        g, devices, links, qc.node_bits,
        pref_counts=[len(p) for p in chain_prefixes(g)])
    for new_links in (
            (LinkProfile("slow", 12e6),),
            (LinkProfile("dyn", 50e6, trace=_step_trace(50e6)),)):
        warm = plan_fast.retime_tables(tables, new_links)
        assert warm.bw == tuple(lk.bandwidth_bps for lk in new_links)
        hot = coach_offline_multihop(g, devices, new_links, tables=warm)
        cold = coach_offline_multihop(g, devices, new_links)
        assert hot.decision.cuts == cold.decision.cuts
        assert hot.decision.all_hop_bits == cold.decision.all_hop_bits
        assert math.isclose(hot.objective, cold.objective, rel_tol=1e-12)


def test_warm_tables_reject_mismatched_links():
    """Stale warm tables (wrong nominal rates for the links being
    planned) must be rejected, not silently misprice the search."""
    g = chain_graph("c", [1e8] * 6, [30_000] * 6)
    qc = QuantCache(g, 0.005, analytic_acc_loss)
    tables = plan_fast.build_tables(
        g, (END, CLOUD), (L1,), qc.node_bits,
        pref_counts=[len(p) for p in chain_prefixes(g)])
    with pytest.raises(AssertionError):
        coach_offline_multihop(g, (END, CLOUD), (L2,), tables=tables)


def test_brute_force_traced_fast_equals_naive():
    rng = np.random.default_rng(3)
    g = chain_graph("c3", rng.uniform(1e7, 1e9, 9),
                    rng.integers(1e3, 3e5, 9))
    traced = LinkProfile("dyn", 50e6, trace=_step_trace(50e6))
    naive = brute_force(g, END, CLOUD, traced, fast=False)
    fast = brute_force(g, END, CLOUD, traced, fast=True)
    assert fast.decision.end_set == naive.decision.end_set
    assert fast.decision.bits == naive.decision.bits
    assert math.isclose(fast.objective, naive.objective, rel_tol=1e-9)


def test_brute_force_fast_equals_naive():
    for seed in (0, 7):
        rng = np.random.default_rng(seed)
        g = chain_graph(f"c{seed}", rng.uniform(1e7, 1e9, 9),
                        rng.integers(1e3, 3e5, 9))
        naive = brute_force(g, END, CLOUD, L1, fast=False)
        fast = brute_force(g, END, CLOUD, L1, fast=True)
        assert fast.decision.end_set == naive.decision.end_set
        assert fast.decision.bits == naive.decision.bits
        assert math.isclose(fast.objective, naive.objective, rel_tol=1e-9)
    # coach (fast) still matches the exponential oracle on the SP DAG
    g = rand_sp_graph(11, n_blocks=2)
    if len(g) <= 18:
        r1 = coach_offline(g, END, CLOUD, L1)
        r2 = brute_force(g, END, CLOUD, L1)
        assert r1.objective <= r2.objective * 1.25


# ----------------------------------------------------- quant memoization
def test_quant_cache_memoizes_dichotomous_search():
    g = vgg16()
    calls = [0]

    def counting_oracle(node, bits):
        calls[0] += 1
        return analytic_acc_loss(node, bits)

    qc = QuantCache(g, 0.005, counting_oracle)
    prefixes = chain_prefixes(g)
    frontiers = [frozenset(p) for p in prefixes[1:]]
    for f in frontiers:
        qc.boundary_bits(f)
    first_pass = calls[0]
    for f in frontiers:  # every frontier + node already memoized
        qc.boundary_bits(f)
    assert calls[0] == first_pass
    # at most one dichotomous search (<= log2(16-2)+2 evals) per producer
    assert first_pass <= 6 * len(g)
    # cache agrees with the direct search
    for f in frontiers[::3]:
        assert qc.boundary_bits(f) == _quantize_boundary(
            g, f, 0.005, counting_oracle)
        assert _quantize_boundary(g, f, 0.005, counting_oracle,
                                  cache=qc) is qc.boundary_bits(f)


def test_tables_price_edges_lazily():
    """The Eq. 1 oracle search runs only for producers whose edges can
    actually cross a swept cut (matching the naive search's on-demand
    quantization — an expensive oracle is not paid for interior edges)."""
    g = resnet101()
    priced = set()

    def counting_bits(u):
        priced.add(u)
        return 8

    tables = plan_fast.build_tables(
        g, *DEPLOYMENTS[1], counting_bits,
        pref_counts=[len(p) for p in chain_prefixes(g)])
    grid_priced = len(priced)
    # block-interior producers (e.g. the first 1x1 conv of a bottleneck)
    # never cross a chain position, so they are not priced up front
    assert grid_priced < len(g) - 1
    # refining inside a block prices the newly exposed producers on demand
    elems = chain_flow(g)
    block = next(e for e in elems if e.is_block and e.branches)
    inner = block.branches[0][0]
    assert inner not in priced
    frontier = frozenset(range(inner + 1))
    plan_fast.stage_times_frontiers(tables, [frontier], extra=0)
    assert inner in priced and len(priced) > grid_priced
    # explicit bit maps never need the oracle
    before = len(priced)
    plan_fast.stage_times_frontiers(
        tables, [frozenset(range(block.block_nodes[-1] + 1))],
        hop_bits=[{}])
    assert len(priced) == before


def test_quant_cache_rejects_mismatched_search_config():
    g = vgg16()
    qc = QuantCache(g, 0.005, analytic_acc_loss)
    f = frozenset(range(4))
    with pytest.raises(AssertionError):
        _quantize_boundary(g, f, 0.02, analytic_acc_loss, cache=qc)
    with pytest.raises(AssertionError):
        _quantize_boundary(g, f, 0.005, analytic_acc_loss, hi_bits=12,
                           cache=qc)


def test_chain_flow_position_map_consistent():
    """The id->position map + hoisted block set (hot-spot fix) keep
    chain_flow's covering/clustering semantics on id-subset inputs."""
    g = rand_sp_graph(4)
    elems = chain_flow(g)
    ids = [i for e in elems for i in e.ids()]
    assert sorted(ids) == list(range(len(g)))
    # restricting to a suffix of ids still walks via the position map
    sub = list(range(len(g) // 2, len(g)))
    sub_elems = chain_flow(g, ids=sub)
    sub_ids = [i for e in sub_elems for i in e.ids()]
    assert sorted(sub_ids) == sub


# ------------------------------------------------- lower-bound pruning
@pytest.mark.parametrize("seed", [0, 1, 3, 5])
def test_chain_sweep_pruning_keeps_argmin_exact(seed):
    """chain_sweep(prune=True) skips dominated non-serial replays but
    (a) scores the exhaustive argmin (and its whole near-tie band)
    exactly, (b) assigns every pruned tuple a true lower bound /
    feasibility upper bound, so the shortlist -> event-sim rescore still
    returns the naive winner."""
    g = rand_sp_graph(seed)
    devices, links = DEPLOYMENTS[2]
    tables, qc, prefixes = build_tables(g, devices, links)
    positions = list(range(len(prefixes)))
    full = plan_fast.chain_sweep(tables, positions, n_hops=2)
    pruned = plan_fast.chain_sweep(tables, positions, n_hops=2,
                                   prune=True)
    assert pruned.combos == full.combos
    assert full.n_pruned == 0
    assert 0 <= pruned.n_pruned < len(full.combos)

    # pruned values never overstate the objective or understate
    # infeasibility: bound semantics hold tuple by tuple
    assert np.all(pruned.objective
                  <= full.objective * (1 + 1e-9) + 1e-12)
    assert np.all(pruned.feasible >= full.feasible)

    def argsort(res):
        return np.lexsort((np.arange(len(res.objective)),
                           res.objective, ~res.feasible))

    best = int(argsort(full)[0])
    # the exhaustive winner is exactly scored under pruning...
    assert math.isclose(pruned.objective[best], full.objective[best],
                        rel_tol=1e-9, abs_tol=1e-12)
    assert bool(pruned.feasible[best]) == bool(full.feasible[best])
    # ...and stays the winner (same index: pruned bounds sort strictly
    # after the incumbent, so the tie-break cannot move)
    assert int(argsort(pruned)[0]) == best
    # the rescoring shortlist drawn from the pruned sweep contains it
    pick = plan_fast._shortlist(pruned.objective, pruned.feasible,
                                top_k=8)
    assert best in set(int(i) for i in pick)


def test_chain_sweep_pruning_actually_prunes():
    """On a sweep with many dominated non-serial tuples the bound skips
    a nonzero tail (otherwise the satellite is a no-op) and
    chain_shortlist reports the same candidates' winner either way."""
    g = resnet101()
    devices, links = DEPLOYMENTS[2]
    tables, qc, prefixes = build_tables(g, devices, links)
    positions = list(range(len(prefixes)))
    pruned = plan_fast.chain_sweep(tables, positions, n_hops=2,
                                   prune=True)
    assert pruned.n_pruned > 0
