"""Bubble attribution: classify every idle gap on every resource.

The paper's objective (Eq. 5-6) is a sum of per-resource idle time
("bubbles").  ``PipelineResult.bubble_fraction`` reports *how much* a
resource idled; this module says *why*.  Given a span trace
(``repro_torch.obs.trace``), ``attribute`` partitions each resource's horizon
into busy intervals and attributed gaps, assigning every gap exactly
one cause from the closed set ``CAUSES``:

``warmup`` / ``drain``
    before the resource's first busy interval / after its last — the
    pipeline fill/flush cost every stream pays.
``upstream_starvation``
    the next task's input was not ready until the gap's end and no more
    specific mechanism explains the delay (sparse arrivals, slow
    upstream service).
``downstream_backpressure``
    work *was* ready before the gap ended yet the resource stayed idle
    — the signature of a bounded-queue stall (the upstream worker sat
    blocked on a full queue after finishing service).  Always zero in
    simulator traces and in pinned unbounded-queue runs.
``batch_formation``
    the delivering upstream service interval was a multi-member
    micro-batch, so the head's data surfaced only when the whole batch
    finished.
``sequencer_reorder``
    a pool sequencer held the head's release to restore stream order
    (``seq_hold`` span overlapping the gap).
``ingress_credit``
    the multi-tenant admission gate withheld the head until a credit
    freed (``credit_wait`` span ending at the gap's end).
``exit_released``
    a semantic early exit upstream released this resource during the
    gap: tasks that would have occupied it never arrived.
``replanning``
    the head task was migrated to a new plan at an upstream hop
    boundary during the gap (``replan`` span): the idle time is the
    cost of switching cut/bits mid-stream, not steady-state starvation.

Classification precedence (first match wins, documented order):
``warmup``/``drain`` by position; then the two mechanisms that delay a
head task *past its own readiness* — ``ingress_credit`` (tier-0
compute) and ``sequencer_reorder`` (links); then, when the head was
not ready before the gap closed, ``batch_formation``,
``exit_released``, ``replanning``, ``upstream_starvation`` in that
order; otherwise ``downstream_backpressure``.  Gaps partition the horizon
minus the busy union by construction, so the conservation identity

    ``busy + sum(attributed bubbles) == horizon``        (per resource)

holds to float-summation error; ``Attribution.conservation_error``
recomputes both sides independently so tests can gate it at 1e-9.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import (CREDIT_WAIT, EXIT_RELEASE, REPLAN, SEQ_HOLD,
                             SERVICE, XFER, Resource, Span, TraceLike,
                             is_link, resource_label, spans_of, tier_of)

__all__ = [
    "WARMUP", "DRAIN", "UPSTREAM_STARVATION", "DOWNSTREAM_BACKPRESSURE",
    "BATCH_FORMATION", "SEQUENCER_REORDER", "INGRESS_CREDIT",
    "EXIT_RELEASED", "REPLANNING", "CAUSES", "Bubble", "Attribution",
    "attribute", "chain_resources",
]

WARMUP = "warmup"
DRAIN = "drain"
UPSTREAM_STARVATION = "upstream_starvation"
DOWNSTREAM_BACKPRESSURE = "downstream_backpressure"
BATCH_FORMATION = "batch_formation"
SEQUENCER_REORDER = "sequencer_reorder"
INGRESS_CREDIT = "ingress_credit"
EXIT_RELEASED = "exit_released"
REPLANNING = "replanning"

#: The closed cause set — every attributed gap carries exactly one.
CAUSES = (WARMUP, DRAIN, UPSTREAM_STARVATION, DOWNSTREAM_BACKPRESSURE,
          BATCH_FORMATION, SEQUENCER_REORDER, INGRESS_CREDIT,
          EXIT_RELEASED, REPLANNING)


@dataclass(frozen=True)
class Bubble:
    """One attributed idle interval on one resource."""

    resource: Resource
    t0: float
    t1: float
    cause: str
    task: Optional[int] = None  # head task whose start closed the gap

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclass
class Attribution:
    """Per-resource busy totals plus the attributed bubble list."""

    horizon: Tuple[float, float]
    busy: Dict[Resource, float]
    bubbles: List[Bubble] = field(default_factory=list)

    @property
    def horizon_s(self) -> float:
        return self.horizon[1] - self.horizon[0]

    def resources(self) -> List[Resource]:
        return sorted(self.busy)

    def seconds(self) -> Dict[Resource, Dict[str, float]]:
        """``{resource: {cause: seconds}}`` with every cause present."""
        out = {r: {c: 0.0 for c in CAUSES} for r in self.busy}
        for b in self.bubbles:
            out[b.resource][b.cause] += b.dur
        return out

    def total(self, resource: Optional[Resource] = None,
              cause: Optional[str] = None) -> float:
        return sum(b.dur for b in self.bubbles
                   if (resource is None or b.resource == resource)
                   and (cause is None or b.cause == cause))

    def conservation_error(self) -> Dict[Resource, float]:
        """``|busy + sum(bubbles) - horizon|`` per resource.

        ``busy`` comes from the busy-interval union and the bubbles
        from the gap walk — independent summations, so this is a real
        check of the partition, not an identity.
        """
        h = self.horizon_s
        return {r: abs(self.busy[r] + self.total(r) - h) for r in self.busy}

    def max_conservation_error(self) -> float:
        errs = self.conservation_error()
        return max(errs.values()) if errs else 0.0

    def by_label(self) -> Dict[str, Dict[str, float]]:
        """JSON-friendly view: ``{label: {cause: seconds}}``."""
        return {resource_label(r): cs for r, cs in self.seconds().items()}

    def busy_by_label(self) -> Dict[str, float]:
        return {resource_label(r): v for r, v in self.busy.items()}


def chain_resources(n_hops: int,
                    pool_sizes: Optional[Sequence[int]] = None
                    ) -> List[Resource]:
    """The full resource set of an ``n_hops``-hop pipeline, including
    resources a traced run may never have touched (so fully-idle
    replicas still get a conservation row)."""
    sizes = list(pool_sizes) if pool_sizes else [1] * (n_hops + 1)
    out: List[Resource] = []
    for k in range(n_hops + 1):
        out.extend(("compute", k, r) for r in range(sizes[k]))
        if k < n_hops:
            out.append(("link", k))
    return out


def _union_length(ivs: List[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    for s, e in ivs:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _skips(resource: Resource, exit_hop: int) -> bool:
    """Did a task exiting at ``exit_hop`` skip ``resource``?  An exit at
    hop ``e`` occupies compute ``0..e`` and links ``0..e-1``."""
    k = tier_of(resource)
    return exit_hop <= k if is_link(resource) else exit_hop < k


def attribute(trace: TraceLike,
              resources: Optional[Sequence[Resource]] = None,
              horizon: Optional[Tuple[float, float]] = None,
              eps: float = 1e-9) -> Attribution:
    """Attribute every idle gap of every resource to one cause.

    ``resources`` defaults to those with busy spans in the trace; pass
    ``chain_resources(...)`` to account for never-touched replicas.
    ``horizon`` defaults to ``[min span t0, max span t1]`` — the
    stream's makespan window, matching ``PipelineResult.makespan``.
    ``eps`` is the instant-coincidence tolerance used by the
    classification predicates (the instants compared originate from one
    engine, so coincident events are exact-float equal in practice).
    """
    spans = spans_of(trace)
    if not spans:
        return Attribution((0.0, 0.0), {r: 0.0 for r in resources or ()})
    if horizon is None:
        horizon = (min(s.t0 for s in spans), max(s.t1 for s in spans))
    h0, h1 = horizon

    busy_spans: Dict[Resource, List[Span]] = {}
    seq_holds: Dict[int, List[Span]] = {}
    credits: Dict[int, Span] = {}
    exits: List[Tuple[float, int]] = []
    replans: Dict[int, List[Tuple[float, int]]] = {}
    member_batch: Dict[Tuple[int, int], int] = {}
    for s in spans:
        if s.kind in (SERVICE, XFER):
            busy_spans.setdefault(s.resource, []).append(s)
            if s.kind == SERVICE and s.tasks is not None:
                k, n = tier_of(s.resource), s.batch or len(s.tasks)
                for t in s.tasks:
                    member_batch[(k, t)] = n
        elif s.kind == SEQ_HOLD:
            seq_holds.setdefault(s.task, []).append(s)
        elif s.kind == CREDIT_WAIT:
            credits[s.task] = s
        elif s.kind == EXIT_RELEASE:
            exits.append((s.t0, s.hop))
        elif s.kind == REPLAN:
            replans.setdefault(s.task, []).append((s.t0, s.hop))

    if resources is None:
        resources = sorted(busy_spans)

    def classify(res: Resource, g0: float, g1: float,
                 head: Span) -> str:
        k = tier_of(res)
        link = is_link(res)
        ready = head.ready if head.ready is not None else g1
        if not link and k == 0:
            c = credits.get(head.task)
            if c is not None and c.t1 >= g1 - eps and c.t1 > ready + eps:
                return INGRESS_CREDIT
        if link:
            # a sequencer hold delays the head past its own release
            # (``ready`` = tx_ready < gap end), so check it before the
            # readiness gate — exactly like the ingress credit above
            for h in seq_holds.get(head.task, ()):
                if h.resource == res and h.t1 >= g1 - eps \
                        and h.t1 > ready + eps:
                    return SEQUENCER_REORDER
        if ready >= g1 - eps:
            src_tier = k if link else k - 1
            if src_tier >= 0 and member_batch.get(
                    (src_tier, head.task), 1) >= 2:
                return BATCH_FORMATION
            for t, hop in exits:
                if g0 - eps <= t <= g1 + eps and _skips(res, hop):
                    return EXIT_RELEASED
            # a migration at an upstream boundary during the gap: the
            # head's arrival was delayed by the plan switch (a replan at
            # hop j takes effect on link j, so it feeds link k >= j and
            # compute k > j)
            for t, hop in replans.get(head.task, ()):
                if g0 - eps <= t <= g1 + eps \
                        and (hop <= k if link else hop < k):
                    return REPLANNING
            return UPSTREAM_STARVATION
        return DOWNSTREAM_BACKPRESSURE

    busy: Dict[Resource, float] = {}
    bubbles: List[Bubble] = []
    for res in resources:
        ivs = sorted(busy_spans.get(res, []), key=lambda s: (s.t0, s.t1))
        busy[res] = _union_length([(s.t0, s.t1) for s in ivs])
        if not ivs:
            if h1 > h0 + eps:
                cause = EXIT_RELEASED if any(
                    _skips(res, hop) for _, hop in exits) else WARMUP
                bubbles.append(Bubble(res, h0, h1, cause))
            continue
        cur = h0
        first = True
        for sp in ivs:
            if sp.t0 > cur + eps:
                cause = WARMUP if first else classify(res, cur, sp.t0, sp)
                bubbles.append(Bubble(res, cur, sp.t0, cause, sp.task))
            if sp.t1 > cur:
                cur = sp.t1
            first = False
        if h1 > cur + eps:
            bubbles.append(Bubble(res, cur, h1, DRAIN))
    return Attribution(horizon, busy, bubbles)
