"""Dual-engine scenario runners: every scenario run is a pin check.

:func:`run_dual` executes one compiled scenario on *both* engines —
``core.pipeline.run_pipeline`` (arithmetic replay) and
``serving.async_engine.run_pipeline_async`` (event-driven executor) —
with fresh trace recorders, fresh routers, and a reset migration hook
per run, then asserts the span traces match at the repo's 1e-6
differential tolerance.  The scenario layer never gets a result the two
engines disagree on; the pin is the API, not an optional test.

:func:`run_chain_scenario` is the end-to-end path for a serial-chain
deployment: compile the timeline's link shifts into traced profiles,
run the deterministic re-planning pass (``replan_timeline``), and
execute the versioned plan schedule with hop-boundary migration on both
engines.  :func:`run_churn_scenario` is the replicated-pool path:
compile replica down-windows into an :class:`AvailabilityRouter` and
pin the churn storyline (the chain ``migrate`` hook does not apply on
the pool path — the sim rejects it — so churn runs are static-plan).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

from repro_torch.core.costs import DeviceProfile, LinkProfile, ModelGraph
from repro_torch.core.pipeline import PipelineResult, TaskPlan, run_pipeline
from repro_torch.obs.trace import TraceRecorder, assert_traces_match
from repro_torch.scenarios.churn import router_factory
from repro_torch.scenarios.events import Timeline
from repro_torch.scenarios.replan import PlanSchedule, PlanVersion, replan_timeline
from repro_torch.serving.async_engine import run_pipeline_async

__all__ = ["ScenarioResult", "run_dual", "run_chain_scenario",
           "run_churn_scenario"]

#: Differential tolerance (seconds) pinned on every scenario run.
PIN_TOL = 1e-6

ARRIVAL_SLACK = 1.05


@dataclasses.dataclass
class ScenarioResult:
    """Both engines' results for one scenario run, pinned.

    ``sim``/``async_`` are the two :class:`PipelineResult`\\ s,
    ``traces`` the matching recorders, ``max_done_delta`` the largest
    per-task completion disagreement (bounded by :data:`PIN_TOL`),
    ``n_migrations`` the hook's migration count (identical across
    engines by construction — asserted), ``versions`` the plan versions
    the run executed (single base version for static runs)."""
    sim: PipelineResult
    async_: PipelineResult
    traces: Tuple[TraceRecorder, TraceRecorder]
    max_done_delta: float
    n_migrations: int = 0
    versions: Sequence[PlanVersion] = ()

    @property
    def n_replans(self) -> int:
        return max(0, len(self.versions) - 1)


def run_dual(plans: Sequence[TaskPlan],
             arrivals: Sequence[float],
             links: Optional[Sequence[Optional[LinkProfile]]] = None,
             pools=None,
             make_router: Optional[Callable[[], object]] = None,
             migrate=None,
             reset: Optional[Callable[[], None]] = None
             ) -> ScenarioResult:
    """Run one scenario on both engines and pin traces + completions.

    ``make_router`` is a zero-arg factory (fresh router per engine run —
    projection state must not leak across the pair); ``reset`` is called
    before each run (pass the migration hook's ``reset``).  Returns the
    pinned :class:`ScenarioResult`."""
    def one(runner):
        if reset is not None:
            reset()
        rec = TraceRecorder()
        router = make_router() if make_router is not None else None
        pr = runner(list(plans), arrivals=list(arrivals),
                    links=list(links) if links is not None else None,
                    pools=pools, router=router, sink=rec,
                    migrate=migrate)
        n_mig = getattr(migrate, "n_migrations", 0) if migrate else 0
        return pr, rec, n_mig

    pr_s, rec_s, mig_s = one(run_pipeline)
    pr_a, rec_a, mig_a = one(run_pipeline_async)
    assert mig_s == mig_a, \
        f"engines migrated differently: sim={mig_s} async={mig_a}"
    assert_traces_match(rec_s, rec_a, tol=PIN_TOL)
    delta = max((abs(s.done - a.done)
                 for s, a in zip(pr_s.tasks, pr_a.tasks)), default=0.0)
    assert delta <= PIN_TOL, f"completion delta {delta} exceeds {PIN_TOL}"
    return ScenarioResult(sim=pr_s, async_=pr_a, traces=(rec_s, rec_a),
                          max_done_delta=delta, n_migrations=mig_s)


def run_chain_scenario(graph: ModelGraph,
                       devices: Sequence[DeviceProfile],
                       nominal_links: Sequence[LinkProfile],
                       timeline: Timeline,
                       n_tasks: int,
                       slack: float = ARRIVAL_SLACK,
                       replan: bool = True,
                       eps: float = 0.005,
                       alpha: float = 0.5, threshold: float = 0.25,
                       min_gap: float = 0.0,
                       degraded_tx_scale: float = 1.0,
                       ) -> ScenarioResult:
    """Plan → compile → execute one chain storyline on both engines.

    With ``replan=False`` the base plan rides through the whole
    storyline unmigrated (the static baseline the resilience bench
    compares against); the dynamics themselves — the traced links — are
    identical in both variants, so the comparison isolates the online
    re-planner."""
    links = timeline.link_profiles(nominal_links)
    versions, _ = replan_timeline(
        graph, devices, links, arrivals=[], eps=eps)
    st0 = versions[0].times
    period = st0.max_stage * slack
    arrivals = timeline.arrivals(period, n_tasks)
    if replan:
        versions, _ = replan_timeline(
            graph, devices, links, arrivals, eps=eps, alpha=alpha,
            threshold=threshold, min_gap=min_gap,
            degraded_tx_scale=degraded_tx_scale)
    else:
        versions = versions[:1]
    sched = PlanSchedule(versions, arrivals, n_hops=len(links))
    migrate = sched if len(versions) > 1 else None
    res = run_dual(sched.task_plans(), arrivals, links=links,
                   migrate=migrate, reset=sched.reset)
    res.versions = versions
    return res


def run_churn_scenario(plans: Sequence[TaskPlan],
                       timeline: Timeline,
                       period: float,
                       pools,
                       links: Optional[Sequence[Optional[LinkProfile]]]
                       = None,
                       n_tasks: Optional[int] = None,
                       seed: int = 0) -> ScenarioResult:
    """Execute one replicated-pool churn storyline on both engines.

    Replica dropout manifests only through the availability-aware
    router; the plan set is static (the chain ``migrate`` hook is
    chain-path-only).  The pin covers placement: both engines must route
    around the same down-windows identically."""
    arrivals = timeline.arrivals(period, n_tasks)
    plan_list = [plans[i % len(plans)] for i in range(len(arrivals))]
    return run_dual(plan_list, arrivals, links=links, pools=pools,
                    make_router=router_factory(timeline.availability(),
                                               seed=seed))
