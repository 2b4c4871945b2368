"""Per-pool replica routing policies for replicated-tier pipelines.

A router places each task on one replica of a tier's pool
(``repro_torch.core.sim.PoolSpec``) the instant the task is enqueued at that
tier.  Like the admission policies in ``repro_torch.serving.tenancy``, the
policy object is a deterministic state machine shared verbatim between
the arithmetic simulator (``core.sim.simulate_pool_stream``, which
dispatches tier by tier) and the event-driven executor
(``serving.async_engine``, whose per-pool dispatcher workers interleave
tiers in wall time) — so the differential harness pins the *routing
semantics*, not the policy code.

Two rules make that sharing sound:

* **All state is per tier.**  Projected free times, backlog lists, RNG
  streams, and affinity maps are indexed by tier, and a ``route`` call
  for tier ``k`` touches only tier ``k``'s state.  The executor routes
  tier 1's task while tier 0 is still dispatching; the simulator routes
  all of tier 0, then all of tier 1.  Both orders make the *same*
  per-tier call sequences, so they reach identical decisions.
* **Decisions never read a clock.**  A ``route(k, ready, compute,
  tenant)`` call sees only the task's carried input-ready instant and
  the router's own projections (``free[r] -> max(free[r], ready) +
  speeds[r] * compute``); wall/virtual time never enters, so concurrency
  can change timing but never placement — the repo-wide invariant.

The projections deliberately ignore data-done gating, batching
amortization, and credit-gate hold times: they are a routing *score*,
not the timeline (the simulator owns that).  Both sides use the same
score, which is all the pinning needs.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.sim import PoolSpec

__all__ = [
    "RouterPolicy", "JoinShortestQueue", "PowerOfTwoChoices",
    "RandomRouter", "TenantAffinity", "ROUTER_POLICIES", "make_router",
]


class RouterPolicy:
    """Base class: per-tier projection state + the ``route`` bookkeeping.

    Subclasses implement ``pick(k, ready, compute, tenant) -> replica``;
    ``route`` wraps it with the shared state update so every policy
    projects identically.  ``reset(pools)`` must be called (by the
    simulator, executor, or admission gate) before the first ``route``.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.pools: Tuple[PoolSpec, ...] = ()
        self._metrics = None

    def attach_metrics(self, registry) -> None:
        """Optional live counter hook (``obs.metrics.MetricsRegistry``):
        every ``route`` call increments ``router.tier{k}.r{r}``.  Counts
        raw ``route`` invocations — including any projection pre-run an
        admission gate performs before the replay resets the state — so
        for placement counts pinned across engines prefer the trace-
        derived ``tier{k}.route.r{r}`` counters
        (``obs.metrics.populate_from_trace``).  Survives ``reset``."""
        self._metrics = registry

    def reset(self, pools: Sequence[PoolSpec]) -> None:
        self.pools = tuple(pools)
        # projected replica free instants / outstanding completion lists,
        # one entry per (tier, replica); RNG + affinity state per tier
        self._free: List[List[float]] = [[0.0] * p.m for p in self.pools]
        self._fins: List[List[List[float]]] = \
            [[[] for _ in range(p.m)] for p in self.pools]
        self._rng = [random.Random(self.seed + k)
                     for k in range(len(self.pools))]
        self._affinity: List[Dict[int, int]] = [{} for _ in self.pools]

    # ------------------------------------------------------------- scoring
    def _backlog(self, k: int, r: int, ready: float) -> int:
        """Projected queue depth of replica ``r`` as seen by a task whose
        input is ready at ``ready``: outstanding routed tasks whose
        projected completion lies beyond ``ready``."""
        fins = self._fins[k][r]
        if fins and fins[0] <= ready:
            fins = [f for f in fins if f > ready]
            self._fins[k][r] = fins
        return len(fins)

    def _projected_fin(self, k: int, r: int, ready: float,
                       compute: float) -> float:
        return max(self._free[k][r], ready) \
            + self.pools[k].speeds[r] * compute

    def _shortest(self, k: int, ready: float, compute: float,
                  among: Optional[Sequence[int]] = None) -> int:
        """JSQ score: least backlog, then earliest projected finish, then
        lowest index — over ``among`` (default: the whole pool)."""
        cands = range(self.pools[k].m) if among is None else among
        return min(cands, key=lambda r: (self._backlog(k, r, ready),
                                         self._projected_fin(
                                             k, r, ready, compute), r))

    # ------------------------------------------------------------ interface
    def pick(self, k: int, ready: float, compute: float,
             tenant: Optional[int]) -> int:
        raise NotImplementedError

    def route(self, k: int, ready: float, compute: float,
              tenant: Optional[int] = None) -> int:
        """Place one task: delegate to ``pick``, then record the
        projection (identical bookkeeping for every policy)."""
        r = self.pick(k, float(ready), float(compute), tenant)
        fin = self._projected_fin(k, r, ready, compute)
        self._free[k][r] = fin
        self._fins[k][r].append(fin)
        if self._metrics is not None:
            self._metrics.inc(f"router.tier{k}.r{r}")
        return r


class JoinShortestQueue(RouterPolicy):
    """Route to the replica with the least projected backlog (ties by
    earliest projected finish, then index)."""

    def pick(self, k, ready, compute, tenant):
        return self._shortest(k, ready, compute)


class PowerOfTwoChoices(RouterPolicy):
    """Sample two distinct replicas from the tier's seeded RNG stream and
    keep the better one (classic load-balancing: near-JSQ balance at two
    probes' worth of state).  Degenerates to the single replica at
    ``m = 1``."""

    def pick(self, k, ready, compute, tenant):
        m = self.pools[k].m
        if m == 1:
            return 0
        rng = self._rng[k]
        a = rng.randrange(m)
        b = rng.randrange(m - 1)
        if b >= a:
            b += 1
        return self._shortest(k, ready, compute, among=(a, b))


class RandomRouter(RouterPolicy):
    """Uniform seeded random placement — the no-information baseline the
    routing bench compares JSQ/po2 against."""

    def pick(self, k, ready, compute, tenant):
        return self._rng[k].randrange(self.pools[k].m)


class TenantAffinity(RouterPolicy):
    """Sticky per-(tier, tenant) placement: a tenant's first task on a
    tier is placed JSQ-style and every later task follows it (warm
    per-tenant state: caches, sessions).  Untagged tasks fall back to
    plain JSQ per call."""

    def pick(self, k, ready, compute, tenant):
        if tenant is None:
            return self._shortest(k, ready, compute)
        amap = self._affinity[k]
        if tenant not in amap:
            amap[tenant] = self._shortest(k, ready, compute)
        return amap[tenant]


ROUTER_POLICIES = {
    "jsq": JoinShortestQueue,
    "po2": PowerOfTwoChoices,
    "random": RandomRouter,
    "affinity": TenantAffinity,
}


def make_router(policy, seed: int = 0) -> RouterPolicy:
    """Instantiate a router from a name in ``ROUTER_POLICIES`` (or pass a
    ``RouterPolicy`` instance through unchanged)."""
    if isinstance(policy, RouterPolicy):
        return policy
    try:
        return ROUTER_POLICIES[policy](seed=seed)
    except KeyError:
        raise ValueError(
            f"unknown router policy {policy!r}; "
            f"expected one of {sorted(ROUTER_POLICIES)}") from None
