"""Fleet-scale dynamics: scripted churn/failure scenarios over the
COACH pipeline, with online re-planning.

A scenario is a :class:`~repro_torch.scenarios.events.Timeline` of first-class
dynamics events — piecewise link degradation/recovery, replica
dropout/rejoin, tenant arrival/departure, diurnal load scaling —
compiled into inputs both engines already consume under the
differential pin:

* link events become per-hop bandwidth **step traces** (``core.sim``
  re-integrates each transfer at its start instant; the async executor
  is pinned to the same integration),
* replica events become availability windows consumed by the clock-free
  :class:`~repro_torch.scenarios.churn.AvailabilityRouter`,
* tenant/load events become explicit per-tenant arrival schedules.

On top of the compiled scenario, :mod:`repro_torch.scenarios.replan` re-runs
the offline planner at detected regime shifts (bandwidth-EMA drift)
with warm-started ``plan_fast`` tables and migrates in-flight tasks at
hop boundaries through the engines' ``migrate`` hook — the 1e-6
sim/async differential pin extends across mid-stream plan switches
(``repro_torch.scenarios.runner`` asserts it on every run).
"""

from repro_torch.scenarios.churn import AvailabilityRouter
from repro_torch.scenarios.events import (LinkShift, LoadScale, ReplicaDown,
                                    ReplicaUp, TenantArrive, TenantDepart,
                                    Timeline)
from repro_torch.scenarios.replan import (PlanSchedule, PlanVersion,
                                    RegimeDetector, replan_timeline)
from repro_torch.scenarios.runner import (ScenarioResult, run_chain_scenario,
                                    run_churn_scenario, run_dual)

__all__ = [
    "LinkShift", "ReplicaDown", "ReplicaUp", "TenantArrive",
    "TenantDepart", "LoadScale", "Timeline",
    "AvailabilityRouter",
    "RegimeDetector", "PlanVersion", "PlanSchedule", "replan_timeline",
    "ScenarioResult", "run_dual", "run_chain_scenario",
    "run_churn_scenario",
]
