"""Auto batch-size finder for continuous micro-batching.

The compute workers of ``repro_torch.serving.async_engine`` drain their hop
queue into dynamic micro-batches (``sim.greedy_batch_size``); the knob
that matters is the per-tier ``batch_cap``.  This module picks it the
way Lightning's ``batch_size_finder`` picks a training batch size:
probe geometrically (1, 2, 4, ...) against a measured batched segment
time until the constraint breaks, then binary-search the boundary.

The constraint here is latency, not memory: a batch of ``n`` holds its
head task for ``measure(n) - measure(1)`` longer than unbatched service
would, so the largest admissible cap is the largest ``n`` whose marginal
latency cost still fits inside the tier's share of the SLO slack.  With
the calibrated service model ``measure(n) = t_fixed + n * t_marginal``
(``repro_torch.core.costs.segment_batch_split``) the cost is
``(n - 1) * t_marginal`` — but ``find_batch_cap`` only assumes
``measure`` is non-decreasing, so measured wall-time probes of a real
deployment plug in unchanged.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from repro_torch.core import sim

__all__ = ["find_batch_cap", "auto_batch_caps", "realized_batch_sizes"]


def find_batch_cap(measure: Callable[[int], float], slack: float,
                   cap_limit: int = 32) -> int:
    """Largest ``n in [1, cap_limit]`` with
    ``measure(n) - measure(1) <= slack``.

    ``measure(n)`` is the tier's batched segment service time at batch
    size ``n`` (calibrated model or wall-clock probe) and must be
    non-decreasing in ``n``.  Geometric doubling finds the first
    power-of-two that breaks the budget, binary search pins the exact
    boundary — O(log cap_limit) probes, never an exhaustive sweep.
    """
    assert cap_limit >= 1
    base = measure(1)

    def fits(n: int) -> bool:
        return measure(n) - base <= slack

    if cap_limit == 1 or not fits(2):
        return 1
    lo = 2
    while lo * 2 <= cap_limit and fits(lo * 2):
        lo *= 2
    hi = min(lo * 2, cap_limit)
    # invariant: fits(lo); first failure (if any) lies in (lo, hi]
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def auto_batch_caps(compute: Sequence[float], t_fixed: Sequence[float],
                    slack: float, cap_limit: int = 32,
                    ingress_cap: Optional[int] = None) -> List[int]:
    """Per-tier batch caps from the calibrated service split.

    ``compute[k]`` / ``t_fixed[k]`` are the offline plan's segment times
    and their per-launch fixed parts; ``slack`` is the end-to-end
    staleness budget (e.g. ``slo_latency - single_task_latency``), split
    evenly across the tiers so the chain's total added latency stays
    inside it.  ``ingress_cap`` clamps tier 0 (the multi-tenant engines
    force it to 1 — credit-gated admission keeps the ingress queue at
    depth <= 1, so batching there is meaningless).

    A tier clamped to cap <= 1 can never *spend* staleness slack —
    batching is off there — so it is excluded from the even split and
    its share is redistributed over the tiers that can batch (giving a
    hard-clamped ingress a full ``1/n`` share would silently waste it;
    downstream caps under the redistribution are always >= the naive
    even-split caps, since ``find_batch_cap`` is monotone in its budget).
    """
    n_seg = len(compute)
    assert len(t_fixed) == n_seg
    clamped = [ingress_cap is not None and int(ingress_cap) <= 1 and k == 0
               for k in range(n_seg)]
    n_eligible = sum(1 for c in clamped if not c)
    per_tier = max(0.0, slack) / n_eligible if n_eligible else 0.0
    caps = []
    for k in range(n_seg):
        if clamped[k]:
            caps.append(1)
            continue
        marginal = compute[k] - t_fixed[k]
        caps.append(find_batch_cap(
            lambda n, f=t_fixed[k], m=marginal: f + n * m,
            per_tier, cap_limit))
    if ingress_cap is not None and caps:
        caps[0] = min(caps[0], int(ingress_cap))
    return caps


def realized_batch_sizes(pr, metrics=None) -> List[float]:
    """Mean realized batch size per compute tier of a finished run.

    Each micro-batch occupies its tier for one busy interval, so the
    realized mean batch size at tier ``k`` is (tasks that ran on tier k)
    / (busy intervals on tier k).  ``pr`` is a ``PipelineResult`` (or
    anything with ``tasks`` carrying ``exit_hop`` and
    ``compute_intervals``).  ``metrics`` (an
    ``obs.metrics.MetricsRegistry``) additionally gets one
    ``tier{k}.realized_batch`` gauge per tier."""
    out: List[float] = []
    for k, iv in enumerate(pr.compute_intervals):
        n_tasks = sum(1 for t in pr.tasks
                      if sim.occupies_compute(t.exit_hop, k))
        out.append(n_tasks / len(iv) if iv else 0.0)
        if metrics is not None:
            metrics.set_gauge(f"tier{k}.realized_batch", out[-1])
    return out
