"""Availability-aware replica routing for churn scenarios.

A replica's dropout is *modeled through routing*: the scenario compiles
``ReplicaDown``/``ReplicaUp`` events into down-windows, and this router
simply refuses to place tasks on a replica whose window covers the
task's input-ready instant.  That keeps the repo-wide determinism
invariant intact — availability is evaluated against the task-carried
``ready`` instant, never a clock, so the arithmetic simulator and the
event-driven executor reach identical placements and the differential
pin extends to churn storylines for free.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.serving.routing import RouterPolicy

__all__ = ["AvailabilityRouter", "router_factory"]


class AvailabilityRouter(RouterPolicy):
    """JSQ over the replicas available at the task's ready instant.

    ``windows`` maps ``(tier, replica)`` to sorted half-open down
    intervals ``[down, up)`` (from ``Timeline.availability()``).  A task
    whose input is ready inside a replica's down-window is never placed
    there; when *every* replica of a tier is down the router falls back
    to the full pool (the fleet would rather queue on a dead tier than
    drop tasks — the bubble attribution shows the resulting idle time).
    """

    def __init__(self, windows: Dict[Tuple[int, int],
                                     List[Tuple[float, float]]],
                 seed: int = 0):
        super().__init__(seed=seed)
        self.windows = {k: sorted(v) for k, v in windows.items()}

    def available(self, k: int, r: int, t: float) -> bool:
        for (t0, t1) in self.windows.get((k, r), ()):
            if t0 <= t < t1:
                return False
        return True

    def pick(self, k, ready, compute, tenant):
        up = [r for r in range(self.pools[k].m)
              if self.available(k, r, ready)]
        return self._shortest(k, ready, compute, among=up or None)

    def down_spans(self, k: int) -> Sequence[Tuple[int, float, float]]:
        """Tier ``k``'s down-windows as (replica, down, up) — report
        helper for benches and examples."""
        return [(r, t0, t1) for (kk, r), ws in sorted(self.windows.items())
                if kk == k for (t0, t1) in ws]


def router_factory(windows, seed: int = 0):
    """Fresh-instance factory: each engine run gets its own router so no
    projection state leaks across the differential pair."""
    return lambda: AvailabilityRouter(windows, seed=seed)
