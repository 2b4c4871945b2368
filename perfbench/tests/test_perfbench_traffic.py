"""The traffic generator and the task stream are set by the seed."""

import numpy as np
import pytest

from perfbench.harness import traffic as T
from perfbench.harness.taskstream import TaskStream, task_tokens
from perfbench.harness.window import Reservoir, sample_of
from perfbench.harness.served import Record

SEED = 2**31 + 12345  # the driver's seeds are this large


@pytest.mark.parametrize("name", ["poisson-s8-r63"])
def test_open_schedule_is_one_poisson_schedule(name):
    tr = T.load(name)
    a = T.due_times(tr, 10.0)
    assert a == T.due_times(tr, 10.0)
    assert len(a) == round(tr["rate"] * 10.0)
    assert a[0] == 0.0 and all(0 <= x < 10.0 for x in a)
    assert all(x < y for x, y in zip(a, a[1:]))
    gaps = np.diff(a + [10.0])
    assert np.isclose(np.mean(gaps), 1 / tr["rate"])
    # the gaps are exponential: their quantiles, in the drawn order
    assert 0.9 < np.std(gaps) * tr["rate"] < 1.05
    other = T.due_times(dict(tr, schedule_seed=tr["schedule_seed"] + 1),
                        10.0)
    assert other != a
    np.testing.assert_allclose(np.sort(np.diff(other + [10.0])),
                               np.sort(gaps), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["closed-s8", "closed-s128"])
def test_a_closed_loop_has_no_schedule(name):
    assert T.due_times(T.load(name), 10.0) is None


def test_an_arrival_kind_is_found_by_name(tmp_path, monkeypatch):
    """A new kind is a new file under ``perfbench/traffic/kinds/``."""
    import sys
    import types
    kind = types.ModuleType("perfbench.traffic.kinds.every_second")
    kind.due_times = lambda traffic, seconds: [float(t) for t in
                                               range(int(seconds))]
    monkeypatch.setitem(sys.modules, kind.__name__, kind)
    assert T.due_times({"arrivals": "every_second"}, 3.0) == [0.0, 1.0, 2.0]


def test_task_stream_is_set_by_the_seed():
    s1, s2, s3 = (TaskStream(16, 768, "medium", seed)
                  for seed in (SEED, SEED, SEED + 1))
    t1, t2, t3 = s1.tasks(50), s2.tasks(50), s3.tasks(50)
    for a, b in zip(t1, t2):
        assert a.label == b.label and np.array_equal(a.features, b.features)
    assert any(not np.array_equal(a.features, b.features)
               for a, b in zip(t1, t3))
    toks = task_tokens(t1[0], 8, 50288)
    assert toks.dtype == np.int32 and toks.shape == (8,)
    assert np.all((toks >= 0) & (toks < 50288))


def test_task_stream_is_the_programs():
    """The frozen copy draws what ``CorrelatedTaskStream`` draws."""
    from repro_torch.data.pipeline import CorrelatedTaskStream
    for corr in ("low", "medium", "high"):
        a = TaskStream(16, 64, corr, SEED).tasks(40)
        b = CorrelatedTaskStream(16, 64, corr, SEED).tasks(40)
        for x, y in zip(a, b):
            assert x.id == y.id and x.label == y.label
            assert np.array_equal(x.features, y.features)


def test_sample_is_set_by_the_seed_and_uniform():
    assert sample_of(SEED, 1000) == sample_of(SEED, 1000)
    assert sample_of(SEED, 5) == [0, 1, 2, 3, 4]
    picks = np.concatenate([sample_of(s, 200) for s in range(300)])
    counts = np.bincount(picks, minlength=200)
    assert len(set(sample_of(SEED, 1000))) == 16
    # uniform: each index kept with probability 16 / 200
    assert abs(counts.mean() - 300 * 16 / 200) < 1e-9
    assert counts.min() > 5 and counts.max() < 50
    res = Reservoir(SEED, k=2)
    recs = [Record(i, None) for i in range(10)]
    for r in recs:
        r.packet = ("p",) if res.admit(r) else None
    kept = [r.idx for r in recs if r.packet is not None]
    assert sorted(kept) == sorted(r.idx for r in res.slots)
