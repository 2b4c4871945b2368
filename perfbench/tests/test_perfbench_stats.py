"""Percentile and rate arithmetic, and a stall moving the tail."""

import math

import numpy as np
import pytest

from perfbench.harness.main import Run
from perfbench.harness.served import Record
from perfbench.harness.stats import percentile, spread
from perfbench.metrics import task_p50_ms, task_p95_ms, tokens_per_s


@pytest.mark.parametrize("q", [0, 5, 50, 90, 95, 99, 100])
def test_percentile_matches_numpy(q):
    xs = np.random.default_rng(q).exponential(size=257).tolist()
    assert math.isclose(percentile(xs, q), float(np.percentile(xs, q)),
                        rel_tol=1e-12)


def test_percentile_with_failed_tasks():
    assert percentile([1.0, 2.0, math.inf], 50) == 2.0
    assert percentile([1.0, 2.0, math.inf], 95) == math.inf


def test_spread_is_the_quartile_distance_over_the_median():
    assert math.isclose(spread([1, 2, 3, 4, 5, 6]), (5.25 - 1.75) / 3.5)


def fifo(due, service):
    """Latencies of a single FIFO server: start at max(due, free)."""
    free, out = 0.0, []
    for d, s in zip(due, service):
        start = max(d, free)
        free = start + s
        out.append(free - d)
    return out


def run_of(due, service, seq_len=8):
    recs = []
    for i, (lat, d) in enumerate(zip(fifo(due, service), due)):
        r = Record(i, None, due=d, end=d + lat)
        r.ok = True
        recs.append(r)
    end = max(r.end for r in recs)
    return Run(records=recs, seq_len=seq_len, window_s=end - due[0])


def test_a_stall_moves_the_p95():
    rng = np.random.default_rng(0)
    due = np.cumsum(rng.exponential(1 / 70, size=700)).tolist()
    service = [0.01] * 700
    base = run_of(due, service)
    stalled = list(service)
    stalled[350] = 0.5  # one task stalls: every task behind it waits
    worse = run_of(due, stalled)
    assert task_p95_ms.read(worse) > 1.5 * task_p95_ms.read(base)
    assert task_p50_ms.read(worse) >= task_p50_ms.read(base)


def test_p95_and_p50_are_of_all_tasks_in_ms():
    due = [0.0, 1.0, 2.0, 3.0]
    run = run_of(due, [0.1, 0.2, 0.3, 0.4])
    assert math.isclose(task_p50_ms.read(run), 250.0)
    assert math.isclose(task_p95_ms.read(run), 385.0)
    run.records[0].ok = False  # a failed task misses every limit
    assert task_p95_ms.read(run) is None


def test_tokens_per_s_counts_completed_tasks_over_the_window():
    run = run_of([0.0, 0.1, 0.2], [0.1, 0.1, 0.1], seq_len=512)
    assert math.isclose(run.window_s, 0.3)
    assert math.isclose(tokens_per_s.read(run), 3 * 512 / 0.3)
    run.records[1].ok = False
    assert math.isclose(tokens_per_s.read(run), 2 * 512 / 0.3)
