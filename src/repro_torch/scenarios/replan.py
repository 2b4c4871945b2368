"""Online re-planning: regime detection, versioned plans, migration.

The offline planner prices a partition for one bandwidth regime; a
fleet storyline moves through several.  This module closes the loop
while preserving the repo's determinism invariant — both engines must
reach identical decisions — by splitting re-planning into two phases:

**Deterministic planning pass** (:func:`replan_timeline`).  Walks the
arrival schedule in modeled time, sampling each traced hop's bandwidth
at every arrival instant (information available online at that instant)
into a per-hop EMA (:class:`RegimeDetector`).  When the EMA drifts past
the threshold, the offline planner re-runs against the *effective*
constant-bandwidth profiles with warm-started tables
(``plan_fast.retime_tables`` — the Eq. 1 oracle pricing is never paid
again), producing a new :class:`PlanVersion` activated at the detection
instant.  Because the pass reads only the timeline (no engine state),
both engines consume the identical version list.

**Hop-boundary migration** (:class:`PlanSchedule`).  The engines'
``migrate(idx, k, tx_ready)`` hook is consulted once per task per hop
at the boundary-ready instant — a task-carried instant, identical
across engines.  New admissions get the full new plan (new cut + bits);
an in-flight task keeps its cut (its upstream compute already ran) and
only its remaining transmissions are re-scaled to the new version's
precision (the Eq. 11 lever).  The sim emits a ``replan`` span at each
migration and the bubble attribution charges the induced idle to the
``replanning`` cause.

Replanned transmission durations are priced at the *nominal* bandwidth:
the stream engines interpret ``plan.tx[k]`` as a bit volume at hop
``k``'s nominal rate and re-integrate it under the live trace, so a
plan computed for effective rate ``eff`` must carry
``tx[k] = st.link[k] * eff / nominal`` (same bits, nominal pricing).
"""

from __future__ import annotations

import dataclasses
import math
from bisect import bisect_right
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import plan_fast
from repro_torch.core.costs import DeviceProfile, LinkProfile, ModelGraph
from repro_torch.core.partitioner import (AccOracle, OfflineResult, QuantCache,
                                    analytic_acc_loss, chain_prefixes,
                                    coach_offline_multihop)
from repro_torch.core.pipeline import TaskPlan
from repro_torch.core.schedule import StageTimes

__all__ = ["RegimeDetector", "PlanVersion", "PlanSchedule",
           "plan_for_regime", "replan_timeline"]


class RegimeDetector:
    """Per-hop bandwidth EMA with relative drift detection.

    ``observe(hop, bps)`` folds one sample into hop ``hop``'s EMA and
    reports whether the EMA has drifted more than ``threshold``
    (relative) from the reference rate the current plan was computed
    for; ``rebase()`` moves the reference to the current EMA after a
    re-plan.  Clock-free: callers sample ``links[k].bps_at(arrival)`` at
    task arrival instants, so detection depends only on the timeline.
    """

    def __init__(self, nominal_bps: Sequence[float], alpha: float = 0.5,
                 threshold: float = 0.25):
        self.nominal = tuple(float(b) for b in nominal_bps)
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.reset()

    def reset(self) -> None:
        self.ema = list(self.nominal)
        self.ref = list(self.nominal)

    def observe(self, hop: int, bps: float) -> bool:
        e = self.alpha * float(bps) + (1.0 - self.alpha) * self.ema[hop]
        self.ema[hop] = e
        return abs(e - self.ref[hop]) > self.threshold * self.ref[hop]

    def rebase(self) -> None:
        self.ref = list(self.ema)


@dataclasses.dataclass(frozen=True)
class PlanVersion:
    """One activated plan regime.

    ``plan`` is the full new-admission plan (new cut + bits, priced at
    nominal bandwidth); ``tx_scale[k]`` the precision scale (<= 1 drops
    bits) its regime applies to hop ``k`` transmissions — in-flight
    tasks migrate by re-scaling their own plan's volumes between the
    admission version's and the active version's scales, since their
    cut is already committed upstream."""
    activate_at: float
    plan: TaskPlan
    tx_scale: Tuple[float, ...]
    times: Optional[StageTimes] = None
    eff_bps: Tuple[float, ...] = ()


class PlanSchedule:
    """Versioned plan store + the engines' ``migrate`` hook.

    ``versions`` must be sorted by strictly increasing ``activate_at``
    with the base version first (its instant at or before the first
    arrival).  Each task's *admission version* is the one active at its
    arrival — ``task_plans()`` returns the per-task admission plans to
    hand the engine.  As the hook sees later hop boundaries fall past a
    newer version's activation, it returns the spliced plan once per
    (task, version) transition.

    All hook state is per-task and every decision input (``tx_ready``,
    the version table) is engine-independent, so the sim's sequential
    replay and the executor's interleaved workers migrate identically —
    call :meth:`reset` before each engine run of a differential pair.
    """

    def __init__(self, versions: Sequence[PlanVersion],
                 arrivals: Sequence[float], n_hops: int):
        assert versions, "need at least the base version"
        self.versions = list(versions)
        self.acts = [v.activate_at for v in self.versions]
        assert all(a < b for a, b in zip(self.acts, self.acts[1:])), \
            "versions must be sorted by strictly increasing activate_at"
        self.n_hops = int(n_hops)
        self.arrivals = [float(a) for a in arrivals]
        self.admit_v = [bisect_right(self.acts, a) - 1
                        for a in self.arrivals]
        assert all(w >= 0 for w in self.admit_v), \
            "base version must activate at or before the first arrival"
        self.sim_plans = [self.versions[w].plan.as_sim_plan(self.n_hops)
                          for w in self.admit_v]
        self.reset()

    # ------------------------------------------------------------- plumbing
    def task_plans(self) -> List[TaskPlan]:
        """Per-task admission plans (what the engine runs)."""
        return [self.versions[w].plan for w in self.admit_v]

    def version_at(self, t: float) -> int:
        return bisect_right(self.acts, t) - 1

    def reset(self) -> None:
        """Clear per-run migration state (between engine runs)."""
        self._applied = {}
        self.n_migrations = 0

    # ------------------------------------------------------------- the hook
    def __call__(self, idx: int, k: int, tx_ready: float):
        v = self.version_at(tx_ready)
        w = self._applied.get(idx, self.admit_v[idx])
        if v <= w:  # versions only move forward
            return None
        self._applied[idx] = v
        base = self.sim_plans[idx]
        num = self.versions[v].tx_scale
        den = self.versions[self.admit_v[idx]].tx_scale
        self.n_migrations += 1
        # hops past the version's scale vector are engine padding
        # (zero-volume) and ride through unscaled
        return dataclasses.replace(base, tx=tuple(
            x * (num[j] / den[j]) if j < len(num) else x
            for j, x in enumerate(base.tx)))


# ========================================================== planning passes
def _nominal_plan(st: StageTimes, eff_bps: Sequence[float],
                  nominal_bps: Sequence[float],
                  tx_scale: Sequence[float]) -> TaskPlan:
    """Plan from stage times computed at effective rates, re-priced at
    nominal (same bits) and scaled to the regime's precision."""
    return TaskPlan.multihop(
        compute=st.compute,
        tx=tuple(st.link[k] * eff_bps[k] / nominal_bps[k] * tx_scale[k]
                 for k in range(st.n_hops)),
        tx_offsets=tuple(min(st.tx_offsets[k], st.compute[k])
                         for k in range(st.n_hops)),
        rx_offsets=st.rx_offsets)


def plan_for_regime(graph: ModelGraph, devices: Sequence[DeviceProfile],
                    eff_links: Sequence[LinkProfile],
                    nominal_bps: Sequence[float],
                    tx_scale: Sequence[float],
                    tables: Optional[plan_fast.PlannerTables] = None,
                    eps: float = 0.005,
                    oracle: AccOracle = analytic_acc_loss
                    ) -> Tuple[TaskPlan, OfflineResult]:
    """One (re-)plan: run the offline search against the regime's
    effective constant-bandwidth profiles (warm ``tables`` skip the
    oracle pricing) and price the winning plan at nominal bandwidth."""
    off = coach_offline_multihop(graph, devices, eff_links, eps=eps,
                                 oracle=oracle, tables=tables)
    eff = tuple(lk.bandwidth_bps for lk in eff_links)
    return _nominal_plan(off.times, eff, nominal_bps, tx_scale), off


def replan_timeline(graph: ModelGraph, devices: Sequence[DeviceProfile],
                    links: Sequence[LinkProfile],
                    arrivals: Sequence[float],
                    eps: float = 0.005,
                    oracle: AccOracle = analytic_acc_loss,
                    alpha: float = 0.5, threshold: float = 0.25,
                    min_gap: float = 0.0,
                    degraded_tx_scale: float = 1.0,
                    max_replans: int = 8
                    ) -> Tuple[List[PlanVersion], List[OfflineResult]]:
    """Deterministic online planning pass over one storyline.

    ``links`` are the scenario's (possibly traced) execution profiles;
    their nominal rates are the planning reference.  Returns the sorted
    version list (base version first, activated at ``-inf``) plus the
    per-version :class:`OfflineResult`.  ``degraded_tx_scale`` (< 1) is
    the precision drop applied to hops whose effective rate fell below
    the drift threshold — COACH's online precision adaptation, the lever
    that buys p99 through a degradation window; hops at or above nominal
    keep scale 1.  ``max_replans`` bounds planner work over a storyline
    (re-plans past the cap are skipped, not queued).
    """
    n_hops = len(links)
    nominal = [lk.bandwidth_bps for lk in links]
    qcache = QuantCache(graph, eps, oracle)
    prefixes = chain_prefixes(graph)
    base_links = [LinkProfile(lk.name, lk.bandwidth_bps) for lk in links]
    tables = plan_fast.build_tables(
        graph, devices, base_links, qcache.node_bits,
        pref_counts=[len(p) for p in prefixes])
    plan0, off0 = plan_for_regime(graph, devices, base_links, nominal,
                                  (1.0,) * n_hops, tables=tables,
                                  eps=eps, oracle=oracle)
    versions = [PlanVersion(-math.inf, plan0, (1.0,) * n_hops,
                            times=off0.times, eff_bps=tuple(nominal))]
    results = [off0]
    if all(lk.trace is None for lk in links):
        return versions, results  # static storyline: nothing to detect

    det = RegimeDetector(nominal, alpha=alpha, threshold=threshold)
    last = -math.inf
    for t in arrivals:
        drift = False
        for k, lk in enumerate(links):
            if lk.trace is not None:
                drift |= det.observe(k, lk.bps_at(t))
        if not drift or t - last < min_gap:
            continue
        if len(results) > max_replans:
            break
        eff_links = [LinkProfile(f"{lk.name}@{len(versions)}",
                                 max(det.ema[k], 1.0))
                     for k, lk in enumerate(links)]
        scale = tuple(
            degraded_tx_scale
            if det.ema[k] < nominal[k] * (1.0 - threshold) else 1.0
            for k in range(n_hops))
        plan, off = plan_for_regime(
            graph, devices, eff_links, nominal, scale,
            tables=plan_fast.retime_tables(tables, eff_links),
            eps=eps, oracle=oracle)
        versions.append(PlanVersion(t, plan, scale, times=off.times,
                                    eff_bps=tuple(l.bandwidth_bps
                                                  for l in eff_links)))
        results.append(off)
        det.rebase()
        last = t
    return versions, results
