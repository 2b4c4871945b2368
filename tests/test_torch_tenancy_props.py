"""Hypothesis properties of the port's batched multi-tenant admission
(``repro_torch.serving.tenancy`` over ``repro_torch.core.sim``): twins of
the two batched properties of ``tests/test_tenancy_props.py``.  The hop
count of a drawn mix is ``len(p.tx)``: ``SimPlan`` has no ``n_hops``
field.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core import sim  # noqa: E402
from repro_torch.serving.tenancy import make_policy  # noqa: E402


@st.composite
def tenant_mixes(draw):
    n_hops = draw(st.integers(1, 3))
    n_tenants = draw(st.integers(1, 4))
    plans, arrivals = [], []
    for _ in range(n_tenants):
        n = draw(st.integers(0, 12))
        gaps = draw(st.lists(
            st.floats(0.0, 5e-3, allow_nan=False, allow_infinity=False),
            min_size=n, max_size=n))
        start = draw(st.floats(0.0, 10e-3))
        arr = list(start + np.cumsum([0.0] + gaps[:-1])) if n else []
        ps = []
        for i in range(n):
            comp = tuple(
                draw(st.floats(1e-4, 5e-3)) for _ in range(n_hops + 1))
            tx = tuple(draw(st.floats(0.0, 3e-3)) for _ in range(n_hops))
            ps.append(sim.SimPlan(
                compute=comp, tx=tx, early_exit=draw(st.booleans()),
                exit_hop=draw(st.one_of(st.none(),
                                        st.integers(0, n_hops)))))
        plans.append(ps)
        arrivals.append(arr)
    weights = [draw(st.floats(0.1, 8.0)) for _ in range(n_tenants)]
    return plans, arrivals, weights


@st.composite
def batched_mixes(draw):
    """A tenant mix plus per-tier batch caps, per-plan fixed launch
    fractions and optional staleness deadlines."""
    plans, arrivals, weights = draw(tenant_mixes())
    n_hops = max((len(p.tx) for ps in plans for p in ps), default=1)
    caps = [draw(st.integers(1, 4)) for _ in range(n_hops + 1)]
    for ps, arr in zip(plans, arrivals):
        for p, a in zip(ps, arr):
            frac = draw(st.floats(0.0, 1.0, allow_nan=False))
            p.t_fixed = tuple(c * frac for c in p.compute)
            if draw(st.booleans()):
                p.deadline = a + draw(st.floats(1e-3, 80e-3))
    return plans, arrivals, weights, caps


@settings(max_examples=40, deadline=None)
@given(mix=batched_mixes(), policy=st.sampled_from(["fifo", "rr", "wdrr"]))
def test_batched_multitenant_conserves_tasks_and_stream_order(mix, policy):
    """Whatever the caps, fixed fractions and deadlines: no task is lost
    or duplicated, batching never reorders completions within one
    tenant's stream (per exit tier), and every resource timeline stays
    sorted and disjoint."""
    plans, arrivals, weights, caps = mix
    if not any(plans):
        return
    mt = sim.simulate_multitenant_stream(
        plans, arrivals, make_policy(policy, weights=weights),
        batch_caps=caps)
    expected = {(t, i) for t in range(len(plans))
                for i in range(len(plans[t]))}
    assert len(mt.order) == len(expected)
    assert set(mt.order) == expected
    assert len(mt.stream.done) == len(expected)
    for t in range(len(plans)):
        _, done, _ = mt.tenant_view(t)
        by_tier = {}
        for d, eh in zip(done, mt.tenant_exit_hops(t)):
            by_tier.setdefault(eh, []).append(d)
        for ds in by_tier.values():
            assert all(d0 <= d1 + 1e-9 for d0, d1 in zip(ds, ds[1:]))
    for iv in (mt.stream.compute_intervals + mt.stream.link_intervals):
        assert sim._sorted_disjoint(iv)


@settings(max_examples=30, deadline=None)
@given(mix=batched_mixes(), policy=st.sampled_from(["fifo", "rr", "wdrr"]))
def test_cap_one_multitenant_is_decision_identical(mix, policy):
    """All-ones caps route to the untouched legacy replay: admission
    order and timelines are *bitwise* equal to running without caps
    (policies are stateful, so each run gets a fresh instance)."""
    plans, arrivals, weights, caps = mix
    if not any(plans):
        return
    a = sim.simulate_multitenant_stream(
        plans, arrivals, make_policy(policy, weights=weights))
    b = sim.simulate_multitenant_stream(
        plans, arrivals, make_policy(policy, weights=weights),
        batch_caps=[1] * len(caps))
    assert a.order == b.order
    assert a.stream.done == b.stream.done
    assert a.stream.compute_intervals == b.stream.compute_intervals
    assert a.stream.link_intervals == b.stream.link_intervals
