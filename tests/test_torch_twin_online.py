"""Online component: Eq. 7-11 math, threshold calibration, exit behavior."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core import online as ON
from repro_torch.data.pipeline import CorrelatedTaskStream, make_calibration_set


def test_eq7_running_mean():
    c = ON.SemanticCache(2, 3, max_count=None)
    feats = np.array([[1., 0, 0], [0, 1, 0], [0, 0, 1]])
    for f in feats:
        c.update(f, 0)
    np.testing.assert_allclose(c.centers[0], feats.mean(0))
    assert c.counts[0] == 3


def test_eq7_bounded_window_tracks_drift():
    cu = ON.SemanticCache(1, 2, max_count=None)
    cb = ON.SemanticCache(1, 2, max_count=8)
    for t in range(200):
        f = np.array([t / 10.0, 0.0])
        cu.update(f, 0)
        cb.update(f, 0)
    # bounded cache stays near the recent values; unbounded lags at the mean
    assert abs(cb.centers[0][0] - 19.9) < 1.0
    assert abs(cu.centers[0][0] - 19.9) > 5.0


@given(st.integers(0, 1000), st.integers(2, 30))
@settings(max_examples=30, deadline=None)
def test_separability_properties(seed, n):
    rng = np.random.default_rng(seed)
    sims = rng.uniform(0, 1, n)
    s = ON.separability(sims)
    assert s >= 0
    # identical top-2 => zero separability
    sims[:2] = 0.7
    t = np.sort(sims)[::-1]
    if t[0] == t[1]:
        assert ON.separability(sims) == 0.0


def test_separability_higher_for_cleaner_argmax():
    base = np.full(10, 0.4)
    weak = base.copy(); weak[3] = 0.45
    strong = base.copy(); strong[3] = 0.9
    assert ON.separability(strong) > ON.separability(weak)


def test_cosine_range_and_selfsim():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5, 8))
    sims = ON.cosine(a, a)
    assert np.all(sims >= -1e-9) and np.all(sims <= 1 + 1e-9)
    np.testing.assert_allclose(np.diag(sims), 1.0, atol=1e-9)


def test_calibration_exit_error_bound():
    stream = CorrelatedTaskStream(n_labels=20, dim=48, correlation="medium",
                                  seed=0)
    feats, labels = make_calibration_set(stream, 500)
    cache = ON.SemanticCache(20, 48)
    cache.warm_up(feats, labels)
    th = ON.calibrate_thresholds(cache, feats, labels, eps=0.005)
    # on the calibration set itself, exits above s_ext err <= eps
    wrong = total = 0
    for f, y in zip(feats, labels):
        sims = cache.similarities(f)
        if ON.separability(sims) > th.s_ext:
            total += 1
            wrong += int(np.argmax(sims) != y)
    assert total == 0 or wrong / total <= 0.005 + 1e-9


@given(st.integers(3, 8), st.floats(1e5, 1e8), st.floats(1e-4, 1e-1),
       st.floats(1e-4, 1e-1))
@settings(max_examples=50, deadline=None)
def test_choose_bits_eq11(q_r, bw, t_e, t_c):
    elems = 100_000
    b = ON.choose_bits(q_r, elems, bw, t_e, t_c)
    assert b >= q_r
    # optimality among levels: distance to the non-transmission bound
    levels = [x for x in (3, 4, 5, 6, 8, 12, 16) if x >= q_r]
    obj = lambda bb: abs(elems * bb / bw - max(t_e, t_c))
    assert obj(b) <= min(obj(x) for x in levels) + 1e-12


@given(st.integers(3, 8), st.floats(1e5, 1e8), st.floats(1e5, 1e8),
       st.floats(1e-4, 1e-1), st.floats(1e-4, 1e-1))
@settings(max_examples=60, deadline=None)
def test_choose_bits_monotone_in_bandwidth(q_r, bw_a, bw_b, t_e, t_c):
    """Target-chasing is monotone: more bandwidth never picks fewer bits
    (the Eq. 11 optimum tracks target * bw / elems over a fixed grid)."""
    bw_lo, bw_hi = sorted((bw_a, bw_b))
    elems = 100_000
    assert (ON.choose_bits(q_r, elems, bw_lo, t_e, t_c)
            <= ON.choose_bits(q_r, elems, bw_hi, t_e, t_c))


def _hop_sched(hop_elems, stage_compute):
    cache = ON.SemanticCache(2, 4)
    th = ON.Thresholds(s_ext=float("inf"), s_adj=((0.0, 8),))
    return ON.OnlineScheduler(cache, th, hop_elems[0], stage_compute[0],
                              stage_compute[-1], hop_elems=hop_elems,
                              stage_compute=stage_compute)


@given(st.integers(3, 8), st.floats(1e5, 1e8), st.floats(1e5, 1e8))
@settings(max_examples=40, deadline=None)
def test_choose_hop_bits_degrades_gracefully_without_hop_ema(q_r, bw0, bw1):
    """A hop whose EMA is missing falls back to the end uplink's EMA (the
    only measurement the classic engine takes); once observed, the hop
    chases its own estimate.  Every hop's choice respects Q_c >= Q_r."""
    sched = _hop_sched((10_000, 5_000), (1e-3, 1.5e-3, 1e-3))
    sched.observe_bandwidth(bw0)
    missing = sched.choose_hop_bits(q_r)
    assert len(missing) == 2 and all(b >= q_r for b in missing)
    assert missing[1] == ON.choose_bits(q_r, 5_000, bw0, 1.5e-3, 1e-3)
    sched.observe_hop_bandwidth(1, bw1)
    with_ema = sched.choose_hop_bits(q_r)
    assert with_ema[1] == ON.choose_bits(
        q_r, 5_000, sched.hop_bw_ema[1], 1.5e-3, 1e-3)
    # hop 0 is untouched by hop-1 observations
    assert with_ema[0] == missing[0]


@given(st.integers(0, 1000), st.integers(2, 6), st.integers(4, 32))
@settings(max_examples=40, deadline=None)
def test_cache_centers_stay_unit_scale_under_drift(seed, n_labels, dim):
    """Eq. 7 with a bounded window is a convex combination, so centers
    never leave the scale of the (drifting) feature stream."""
    rng = np.random.default_rng(seed)
    c = ON.SemanticCache(n_labels, dim, max_count=16)
    max_norm = 0.0
    drift = rng.normal(size=dim) * 0.05
    for t in range(200):
        f = rng.normal(size=dim) + drift * t   # random walk of the scene
        max_norm = max(max_norm, float(np.linalg.norm(f)))
        c.update(f, int(rng.integers(n_labels)))
    for j in range(n_labels):
        assert np.linalg.norm(c.centers[j]) <= max_norm + 1e-9


def test_exit_ratio_increases_with_correlation():
    ratios = {}
    for corr in ("low", "medium", "high"):
        stream = CorrelatedTaskStream(n_labels=30, dim=48, correlation=corr,
                                      seed=3)
        feats, labels = make_calibration_set(stream, 400)
        cache = ON.SemanticCache(30, 48)
        cache.warm_up(feats, labels)
        th = ON.calibrate_thresholds(cache, feats, labels)
        sched = ON.OnlineScheduler(cache, th, 10_000, 1e-3, 1e-3)
        ex = 0
        for t in stream.tasks(600):
            d = sched.step(t.features, bandwidth_bps=20e6)
            if d.early_exit:
                ex += 1
            else:
                sched.report_label(t.features, t.label)
        ratios[corr] = ex / 600
    assert ratios["low"] < ratios["medium"] < ratios["high"]


def test_required_bits_decreasing_in_separability():
    th = ON.Thresholds(s_ext=10.0, s_adj=((0.8, 3), (0.5, 4), (0.2, 6)))
    assert th.required_bits(0.9) == 3
    assert th.required_bits(0.6) == 4
    assert th.required_bits(0.3) == 6
    assert th.required_bits(0.05) == 8  # default
