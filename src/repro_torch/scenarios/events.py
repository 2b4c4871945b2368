"""Scenario dynamics events and the timeline that compiles them.

Every event is a frozen record anchored at an absolute instant ``at``
(seconds of modeled time).  A :class:`Timeline` holds one scripted
storyline and compiles it into the representations the two pipeline
engines already execute under the differential pin:

``LinkShift``
    Piecewise bandwidth change of one hop (degradation *and* recovery
    are just shifts).  Compiled by :meth:`Timeline.link_profiles` into a
    per-hop step trace (``core.pipeline.bandwidth_step_trace``); hops
    never shifted stay plain constant-bandwidth profiles, so the
    planner's vectorized fast paths still apply to them.

``ReplicaDown`` / ``ReplicaUp``
    A pool replica leaves / rejoins its tier.  Compiled by
    :meth:`Timeline.availability` into half-open down-windows
    ``[down, up)`` per ``(tier, replica)`` for the clock-free
    :class:`~repro_torch.scenarios.churn.AvailabilityRouter`.

``TenantArrive`` / ``TenantDepart`` / ``LoadScale``
    Stream shape: tenants join with their own arrival period and leave;
    ``LoadScale`` rescales every period from its instant on (diurnal
    load).  Compiled into explicit arrival instants — the engines take
    arrival lists verbatim, so no new engine surface is needed.

All compilation is pure arithmetic over the event list: the same
timeline always produces the same traces, windows and arrivals, which
is what keeps a scenario run deterministic across both engines.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costs import LinkProfile
from repro_torch.core.pipeline import bandwidth_step_trace

__all__ = [
    "LinkShift", "ReplicaDown", "ReplicaUp", "TenantArrive",
    "TenantDepart", "LoadScale", "Timeline",
]


@dataclasses.dataclass(frozen=True)
class LinkShift:
    """Hop ``hop``'s bandwidth becomes ``mbps`` from instant ``at`` on."""
    at: float
    hop: int
    mbps: float


@dataclasses.dataclass(frozen=True)
class ReplicaDown:
    """Replica ``replica`` of tier ``tier`` drops out at ``at``."""
    at: float
    tier: int
    replica: int


@dataclasses.dataclass(frozen=True)
class ReplicaUp:
    """Replica ``replica`` of tier ``tier`` rejoins at ``at``."""
    at: float
    tier: int
    replica: int


@dataclasses.dataclass(frozen=True)
class TenantArrive:
    """Tenant ``tenant`` starts issuing tasks every ``period`` s at
    ``at`` (its first arrival is ``at`` itself)."""
    at: float
    tenant: int
    period: float


@dataclasses.dataclass(frozen=True)
class TenantDepart:
    """Tenant ``tenant`` issues no arrivals at or after ``at``."""
    at: float
    tenant: int


@dataclasses.dataclass(frozen=True)
class LoadScale:
    """Every stream's arrival period is multiplied by ``factor`` from
    ``at`` on (values < 1 mean more load).  Factors replace, they do not
    compound: the factor in effect at ``t`` is the last event's."""
    at: float
    factor: float


class Timeline:
    """One scripted storyline: a sorted event list plus the horizon the
    open-ended compilations (tenant streams, down-windows without a
    rejoin) run to."""

    def __init__(self, events: Sequence, horizon: float):
        assert horizon > 0.0
        self.events = sorted(events, key=lambda e: e.at)
        self.horizon = float(horizon)
        assert all(e.at >= 0.0 for e in self.events), \
            "events must be anchored at non-negative instants"

    def _of(self, cls) -> list:
        return [e for e in self.events if isinstance(e, cls)]

    # ----------------------------------------------------------- link events
    def link_profiles(self, nominal: Sequence[LinkProfile]
                      ) -> List[LinkProfile]:
        """Per-hop profiles with the storyline's shifts folded in as step
        traces.  ``nominal`` are the constant-bandwidth planning profiles;
        a hop with no ``LinkShift`` is returned unchanged (untraced), so
        static deployments compile to the exact static run."""
        shifts: Dict[int, List[Tuple[float, float]]] = {}
        for e in self._of(LinkShift):
            assert 0 <= e.hop < len(nominal), f"no hop {e.hop}"
            shifts.setdefault(e.hop, []).append((e.at, e.mbps))
        out = []
        for k, lk in enumerate(nominal):
            assert lk.trace is None, \
                "nominal profiles must be constant-bandwidth"
            if k not in shifts:
                out.append(lk)
                continue
            steps = [(0.0, lk.bandwidth_bps / 1e6)] + sorted(shifts[k])
            out.append(LinkProfile(f"{lk.name}+dyn", lk.bandwidth_bps,
                                   trace=bandwidth_step_trace(steps)))
        return out

    # -------------------------------------------------------- replica events
    def availability(self) -> Dict[Tuple[int, int],
                                   List[Tuple[float, float]]]:
        """Down-windows ``[down, up)`` per ``(tier, replica)``; a drop
        without a matching rejoin stays down to the horizon."""
        downs: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
        open_at: Dict[Tuple[int, int], float] = {}
        for e in self.events:
            if isinstance(e, ReplicaDown):
                key = (e.tier, e.replica)
                assert key not in open_at, f"replica {key} already down"
                open_at[key] = e.at
            elif isinstance(e, ReplicaUp):
                key = (e.tier, e.replica)
                assert key in open_at, f"replica {key} not down"
                downs.setdefault(key, []).append((open_at.pop(key), e.at))
        for key, t0 in open_at.items():
            downs.setdefault(key, []).append((t0, self.horizon))
        return downs

    # --------------------------------------------------------- load / tenants
    def load_factor(self, t: float) -> float:
        """The ``LoadScale`` factor in effect at ``t`` (1.0 before any)."""
        f = 1.0
        for e in self._of(LoadScale):
            if e.at <= t:
                f = e.factor
        return f

    def _stream(self, start: float, stop: float, period: float,
                n_max: Optional[int] = None) -> List[float]:
        out: List[float] = []
        t = start
        while t < stop and (n_max is None or len(out) < n_max):
            out.append(t)
            t += period * self.load_factor(t)
        return out

    def arrivals(self, period: float,
                 n_tasks: Optional[int] = None) -> List[float]:
        """Single-stream arrival instants from 0 at ``period`` (scaled by
        the load events), up to ``n_tasks`` or the horizon."""
        return self._stream(0.0, self.horizon, period, n_tasks)

    def tenant_arrivals(self) -> Dict[int, List[float]]:
        """Per-tenant arrival lists from the tenant events (keyed by
        tenant id; pass ``dict(sorted(...))`` values to the multi-tenant
        entry points in id order)."""
        departs = {e.tenant: e.at for e in self._of(TenantDepart)}
        out: Dict[int, List[float]] = {}
        for e in self._of(TenantArrive):
            assert e.tenant not in out, f"tenant {e.tenant} arrives twice"
            stop = min(departs.get(e.tenant, self.horizon), self.horizon)
            out[e.tenant] = self._stream(e.at, stop, e.period)
        return out
