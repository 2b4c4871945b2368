"""Offline component: Algorithm 1 vs brute force, virtual blocks,
dichotomous quant search, Eq. 4/5/6 semantics."""

import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core.costs import (DeviceProfile, LinkProfile, LayerNode,
                              ModelGraph, chain_graph)
from repro_torch.core.partitioner import (analytic_acc_loss, brute_force,
                                    chain_flow, coach_offline,
                                    dichotomous_bits)
from repro_torch.core.schedule import PartitionDecision, evaluate_partition
from repro_torch.models.cnn import resnet101, vgg16

END = DeviceProfile("end", 1e11, efficiency=1.0)
CLOUD = DeviceProfile("cloud", 1e12, efficiency=1.0)
LINK = LinkProfile("l", 50e6)


def _rand_chain(seed, n=10):
    rng = np.random.default_rng(seed)
    return chain_graph(f"c{seed}", rng.uniform(1e7, 1e9, n),
                       rng.integers(1e3, 3e5, n),
                       rng.uniform(0.005, 0.08, n).tolist())


@given(st.integers(0, 500))
@settings(max_examples=25, deadline=None)
def test_chain_matches_brute_force(seed):
    g = _rand_chain(seed, n=9)
    r1 = coach_offline(g, END, CLOUD, LINK)
    r2 = brute_force(g, END, CLOUD, LINK)
    assert r1.objective <= r2.objective * (1 + 1e-9), \
        f"coach {r1.objective} worse than brute {r2.objective}"


def test_dag_close_to_brute_force():
    # small series-parallel DAG: 0 -> (1,2 | 3) -> 4 -> 5
    nodes = [
        LayerNode(0, "a", 2e8, 40_000),
        LayerNode(1, "b1", 3e8, 30_000, (0,)),
        LayerNode(2, "b2", 3e8, 20_000, (1,)),
        LayerNode(3, "c1", 4e8, 25_000, (0,)),
        LayerNode(4, "join", 1e8, 20_000, (2, 3)),
        LayerNode(5, "head", 2e8, 1_000, (4,)),
    ]
    g = ModelGraph("sp", nodes)
    r1 = coach_offline(g, END, CLOUD, LINK)
    r2 = brute_force(g, END, CLOUD, LINK)
    # D&C explores a restricted set of DAG cuts: allow small optimality gap
    assert r1.objective <= r2.objective * 1.25


def test_virtual_blocks_resnet():
    g = resnet101()
    elems = chain_flow(g)
    blocks = [e for e in elems if e.is_block]
    assert len(blocks) == 33  # one per bottleneck
    # projection blocks have 2 branches, identity blocks 1
    br = sorted(set(len(b.branches) for b in blocks))
    assert br == [1, 2]
    # block contents + chain nodes cover the graph exactly once
    ids = [i for e in elems for i in e.ids()]
    assert sorted(ids) == list(range(len(g)))


def test_vgg_is_chain():
    g = vgg16()
    assert g.is_chain()
    assert all(not e.is_block for e in chain_flow(g))


@given(st.floats(0.001, 0.05), st.floats(0.005, 0.1))
@settings(max_examples=30, deadline=None)
def test_dichotomous_bits_minimal(eps, sens):
    node = LayerNode(0, "x", 1e8, 1000, sensitivity=sens)
    b = dichotomous_bits(node, eps, analytic_acc_loss)
    assert analytic_acc_loss(node, b) <= eps or b == 16
    if b > 2:
        assert analytic_acc_loss(node, b - 1) > eps  # minimality


def test_quant_meets_accuracy_constraint():
    g = resnet101()
    r = coach_offline(g, END, CLOUD, LINK, eps=0.005)
    for (u, v), bits in r.decision.bits.items():
        assert analytic_acc_loss(g.node(u), bits) <= 0.005 + 1e-12


def test_eq4_parallel_constraint_holds():
    g = resnet101()
    r = coach_offline(g, END, CLOUD, LINK)
    assert r.times.satisfies_parallel_constraint()
    assert r.feasible


def test_objective_is_eq6():
    g = _rand_chain(7)
    r = coach_offline(g, END, CLOUD, LINK)
    t = r.times
    assert math.isclose(r.objective, t.B_c + t.B_t + t.max_stage,
                        rel_tol=1e-12)


def test_evaluate_partition_stage_times_consistent():
    g = _rand_chain(3)
    end = frozenset(range(5))
    bits = {e: 8 for e in g.boundary_edges(end) if e[0] >= 0}
    st_ = evaluate_partition(g, PartitionDecision(end, bits), END, CLOUD, LINK)
    # T_e = sum of end layer times
    te = sum(END.layer_time(g.node(i).flops) for i in end)
    assert math.isclose(st_.T_e, te, rel_tol=1e-9)
    # latency >= each stage
    assert st_.latency >= max(st_.T_e, st_.T_t, st_.T_c) - 1e-12
    # overlaps bounded by busy times
    assert st_.T_t_par <= st_.T_t + 1e-12
    assert st_.T_c_par <= st_.T_c + 1e-12


def test_downward_closure_enforced():
    g = _rand_chain(4)
    bad = frozenset({3, 5})  # 5 requires 4
    with pytest.raises(AssertionError):
        evaluate_partition(g, PartitionDecision(bad, {}), END, CLOUD, LINK)


def test_min_end_nodes_respected():
    g = _rand_chain(5)
    r = coach_offline(g, END, CLOUD, LINK, min_end_nodes=1)
    assert len(r.decision.end_set) >= 1
