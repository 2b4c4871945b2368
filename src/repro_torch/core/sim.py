"""Unified N-stage resource-timeline simulator.

This module is the single discrete-event core behind both the offline
partition scorer (``repro_torch.core.schedule.evaluate_partition``) and the
task-stream executor (``repro_torch.core.pipeline.run_pipeline``).  A
collaborative deployment is modelled as ``2n+1`` alternating *serial FIFO
resources*

    compute_0, link_0, compute_1, link_1, ..., link_{n-1}, compute_n

where ``compute_0`` is the end device, ``compute_n`` the cloud, and the
``compute_k`` in between are edge tiers; the paper's end->link->cloud
testbed is the ``n = 1`` special case.  Mapping onto the paper's
quantities (Eq. 2-6, generalized per hop ``k``):

  T_e, T_t, T_c      Eq. 2 stage busy times -> ``compute[0]``, ``link[k]``,
                     ``compute[k+1]`` (per-resource busy-interval sums).
  Eq. 3              latency budget: the serial stage-time sum must not
                     exceed T_max (checked by the partitioner).
  Eq. 4              parallel constraint: within one hop, the transmission
                     time overlapped with upstream compute (``link_par[k]``)
                     plus the downstream compute overlapped with the
                     transmission (``compute_par[k]``) cannot exceed the
                     pipeline ceiling ``max_stage``.
  Eq. 5              bubbles: B_c is the per-hop compute imbalance
                     ``|compute[k] - compute[k+1]|``; B_t the per-hop link
                     imbalance against the effective ceiling
                     ``max(compute[k], link[k]-link_par[k],
                     compute[k+1]-compute_par[k])``.
  Eq. 6              objective = sum of bubbles + max stage, computed by
                     ``repro_torch.core.schedule.StageTimes`` from this timeline.

Two entry points:

``simulate_partitioned_task``
    One task through a partitioned ``ModelGraph``: each segment executes
    its nodes serially in topological (id) order; every edge whose
    producer and consumer live in different segments becomes a boundary
    tensor that crosses each intervening link in FIFO order (ready when
    the producer finishes, or when the previous hop delivered it).
    Arrivals are recorded **per edge** ``(u, v)`` — not per producer — so
    a producer feeding several boundary edges gates each consumer on the
    transfer it actually consumes.

``simulate_stream``
    A stream of tasks, each a ``SimPlan`` of per-segment compute
    durations and per-hop transmission durations (with optional
    intra-task overlap offsets measured by the single-task simulation),
    replayed over the same ``2n+1`` serial resources.  Per-hop links with
    a bandwidth trace re-integrate each transfer at its actual start
    time (dynamic networks, Fig. 5).

Both entry points share the same event semantics, so the partitioner
scores candidates with exactly the timeline the stream executor replays.

``simulate_multitenant_stream`` extends the stream view to *tagged*
multi-tenant arrivals: several per-tenant task streams are merged into
one admission sequence by a pluggable admission policy (FIFO /
round-robin / weighted deficit round-robin, implemented in
``repro_torch.serving.tenancy``), gated by the shared ingress resource
(``compute_0``), and the merged stream replays over the same ``2n+1``
serial resources.  The async multi-tenant executor
(``repro_torch.serving.tenancy.MultiTenantHopPipeline``) realizes the same
gate with event-driven ingress credits, so the two admission orders —
and therefore the two timelines — are differentially pinned by
``tests/test_tenancy.py``.

``simulate_pool_stream`` generalizes the chain to a DAG of *resource
pools*: tier ``k`` becomes ``PoolSpec`` — ``m`` replica resources with
heterogeneous speed multipliers — behind a pluggable router policy
(join-shortest-queue / power-of-two-choices / tenant-affinity, in
``repro_torch.serving.routing``) that places each task at enqueue time in
per-stream order; a per-pool sequencer restores admission order toward
each serial hop link.  ``m = 1`` unit pools on every tier reduce
bit-identically to ``simulate_stream``, and the async pool executor
(``repro_torch.serving.async_engine.AsyncHopPipeline`` with ``pools=``) is
differentially pinned to it by ``tests/test_pools.py``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costs import DeviceProfile, LinkProfile, ModelGraph
from repro_torch.obs.trace import (BATCH_FORM, CREDIT_WAIT, ENQUEUE, EXIT_RELEASE,
                             REPLAN, ROUTE, SEQ_HOLD, SERVICE, XFER, Span)

Edge = Tuple[int, int]
Interval = Tuple[float, float]


# --------------------------------------------------------- hop-exit helpers
def occupies_compute(exit_hop: Optional[int], k: int) -> bool:
    """Does a task with this ``exit_hop`` occupy compute resource ``k``?
    ``exit_hop = e`` means the task terminates at segment ``e`` (a hop-level
    semantic probe early-exited it there); ``None`` runs the full chain."""
    return exit_hop is None or k <= exit_hop


def occupies_link(exit_hop: Optional[int], k: int) -> bool:
    """Does a task with this ``exit_hop`` occupy link resource ``k``?  A
    task exiting at segment ``e`` crosses links ``0..e-1`` only — every
    downstream link (and compute tier) is released at the exit instant."""
    return exit_hop is None or k < exit_hop


def _sorted_disjoint(iv: Sequence[Interval]) -> bool:
    return all(iv[i][0] <= iv[i][1] and
               (i + 1 == len(iv) or iv[i][1] <= iv[i + 1][0])
               for i in range(len(iv)))


def overlap_sorted_disjoint(intervals_a: Sequence[Interval],
                            intervals_b: Sequence[Interval]) -> float:
    """O(a + b) total overlap of two *sorted disjoint* interval lists —
    the shape every serial-FIFO resource timeline has (also the workhorse
    of the batched planner scorer in ``repro_torch.core.plan_fast``)."""
    i = j = 0
    tot = 0.0
    while i < len(intervals_a) and j < len(intervals_b):
        lo = max(intervals_a[i][0], intervals_b[j][0])
        hi = min(intervals_a[i][1], intervals_b[j][1])
        if hi > lo:
            tot += hi - lo
        if intervals_a[i][1] <= intervals_b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def overlap_total(intervals_a: Sequence[Interval],
                  intervals_b: Sequence[Interval]) -> float:
    """Total overlap between two lists of (start, end) busy intervals.

    The serial-FIFO resources of both simulators emit sorted disjoint
    interval lists, which take the O(a + b) merge scan; anything else
    falls back to the exact pairwise sum."""
    if _sorted_disjoint(intervals_a) and _sorted_disjoint(intervals_b):
        return overlap_sorted_disjoint(intervals_a, intervals_b)
    tot = 0.0
    for (a0, a1) in intervals_a:
        for (b0, b1) in intervals_b:
            lo, hi = max(a0, b0), min(a1, b1)
            if hi > lo:
                tot += hi - lo
    return tot


# ===================================================================== task
@dataclasses.dataclass
class TaskTimeline:
    """Resource timeline of one task through an N-segment partition.

    All per-hop tuples have length ``n_hops``; per-segment tuples have
    length ``n_hops + 1``.  Times are absolute (task starts at 0).
    """
    compute_busy: Tuple[float, ...]       # Eq. 2 per-segment busy time
    link_busy: Tuple[float, ...]          # Eq. 2 per-hop busy time
    link_par: Tuple[float, ...]           # hop tx overlapped w/ upstream compute
    compute_par: Tuple[float, ...]        # downstream compute overlapped w/ tx
    latency: float                        # end-to-end finish
    first_tx: Tuple[float, ...]           # absolute first transfer start / hop
    seg_start: Tuple[float, ...]          # absolute first compute start / segment
    next_start: Tuple[float, ...]         # absolute first downstream compute
                                          # start per hop (= seg_start[k+1])
    # raw per-resource busy intervals (one per node / transfer, in exec order)
    compute_intervals: Tuple[Tuple[Interval, ...], ...] = ()
    link_intervals: Tuple[Tuple[Interval, ...], ...] = ()

    @property
    def n_hops(self) -> int:
        return len(self.link_busy)


def simulate_partitioned_task(
        graph: ModelGraph,
        segments: Sequence[frozenset],
        hop_bits: Sequence[Dict[Edge, int]],
        devices: Sequence[DeviceProfile],
        links: Sequence[LinkProfile],
        input_bits_per_elem: int = 8) -> TaskTimeline:
    """Event-simulate one task through an ordered N-segment partition.

    ``segments`` partitions the node ids into ``n_hops + 1`` ordered sets
    (data flows strictly forward: every dependency lives in the same or an
    earlier segment).  ``hop_bits[k]`` prices the tensors crossing link
    ``k`` (missing edges default to fp32; the raw model input is priced at
    ``input_bits_per_elem`` on every hop it crosses).
    """
    n_seg = len(segments)
    assert len(devices) == n_seg and len(links) == n_seg - 1
    seg_of: Dict[int, int] = {}
    for k, seg in enumerate(segments):
        for i in seg:
            seg_of[i] = k
    seg_of[-1] = 0  # raw input lives on the end device
    for n in graph.nodes:
        assert n.id in seg_of, f"node {n.id} unassigned"
        for d in n.deps:
            assert seg_of[d] <= seg_of[n.id], \
                f"backward edge {d}->{n.id} across segments"

    compute_busy: List[float] = [0.0] * n_seg
    link_busy: List[float] = [0.0] * (n_seg - 1)
    compute_intervals: List[List[Interval]] = [[] for _ in range(n_seg)]
    link_intervals: List[List[Interval]] = [[] for _ in range(n_seg - 1)]
    first_tx: List[Optional[float]] = [None] * (n_seg - 1)
    done: Dict[int, float] = {}
    # recv[k][(u, v)]: edge (u, v) fully delivered over link k (per-edge,
    # not per-producer — see module docstring)
    recv: List[Dict[Edge, float]] = [{} for _ in range(n_seg - 1)]
    seg_finish: List[float] = [0.0] * n_seg
    link_finish: List[float] = [0.0] * (n_seg - 1)

    def edge_bits(k: int, u: int, v: int) -> float:
        if u < 0:
            return float(graph.input_elems) * input_bits_per_elem
        return float(graph.node(u).out_elems) * hop_bits[k].get((u, v), 32)

    # edges crossing each hop: produced at or before segment k, consumed after
    crossing: List[List[Edge]] = [[] for _ in range(n_seg - 1)]
    for n in graph.nodes:
        sv = seg_of[n.id]
        srcs = n.deps if n.deps else ((-1,) if sv > 0 else ())
        for d in srcs:
            for k in range(seg_of[d], sv):
                crossing[k].append((d, n.id))

    for k in range(n_seg):
        # -------- compute segment k: serial, topological (id) order --------
        t = 0.0
        for n in graph.nodes:
            if seg_of[n.id] != k:
                continue
            if k == 0:
                ready_at = 0.0
            else:
                ready_at = 0.0
                for d in n.deps:
                    ready_at = max(ready_at,
                                   done[d] if seg_of[d] == k
                                   else recv[k - 1][(d, n.id)])
                if not n.deps:
                    ready_at = recv[k - 1].get((-1, n.id), 0.0)
            dt = devices[k].layer_time(n.flops, n.util)
            start = max(t, ready_at)
            compute_intervals[k].append((start, start + dt))
            t = start + dt
            done[n.id] = t
            compute_busy[k] += dt
        seg_finish[k] = t

        # -------- link k: FIFO over the tensors crossing this hop ----------
        if k == n_seg - 1:
            break
        ready: List[Tuple[float, Edge, float]] = []
        for (u, v) in crossing[k]:
            if seg_of[u] == k:
                when = done[u] if u >= 0 else 0.0
            else:  # relayed from an earlier hop
                when = recv[k - 1][(u, v)]
            ready.append((when, (u, v), edge_bits(k, u, v)))
        ready.sort(key=lambda r: (r[0], r[1]))
        link_free = 0.0
        for (when, (u, v), bits) in ready:
            start = max(when, link_free)
            dur = links[k].transfer_time(bits, start)
            link_intervals[k].append((start, start + dur))
            if first_tx[k] is None:
                first_tx[k] = start
            link_free = start + dur
            link_busy[k] += dur
            recv[k][(u, v)] = link_free
        link_finish[k] = link_free

    latency = max(seg_finish + link_finish) if graph.nodes else 0.0
    link_par = tuple(overlap_total(link_intervals[k], compute_intervals[k])
                     for k in range(n_seg - 1))
    compute_par = tuple(overlap_total(compute_intervals[k + 1],
                                      link_intervals[k])
                        for k in range(n_seg - 1))
    # fallbacks mirror the classic semantics: with nothing to transmit on a
    # hop, "first tx" collapses to the time everything upstream finished
    ftx: List[float] = []
    upstream = 0.0
    for k in range(n_seg - 1):
        upstream = max(upstream, seg_finish[k])
        ftx.append(first_tx[k] if first_tx[k] is not None else upstream)
        upstream = max(upstream, link_finish[k])
    seg_start = tuple(min((s for s, _ in compute_intervals[k]),
                          default=(ftx[k - 1] if k else 0.0))
                      for k in range(n_seg))
    next_start = tuple(min((s for s, _ in compute_intervals[k + 1]),
                           default=ftx[k])
                       for k in range(n_seg - 1))
    return TaskTimeline(
        compute_busy=tuple(compute_busy), link_busy=tuple(link_busy),
        link_par=link_par, compute_par=compute_par, latency=latency,
        first_tx=tuple(ftx), seg_start=seg_start, next_start=next_start,
        compute_intervals=tuple(tuple(iv) for iv in compute_intervals),
        link_intervals=tuple(tuple(iv) for iv in link_intervals))


# =================================================================== stream
@dataclasses.dataclass
class SimPlan:
    """Per-task resource occupation for the stream simulator.

    ``compute`` has one duration per segment, ``tx`` one per hop.
    ``tx_offset[k]`` (if set, and smaller than ``compute[k]``) lets hop
    ``k``'s transmission start that long after segment ``k``'s compute
    started (Fig. 4 virtual-block overlap); ``rx_offset[k]`` lets segment
    ``k+1`` start that long after hop ``k``'s transmission started.

    ``exit_hop = e`` terminates the task at segment ``e`` (a hop-level
    semantic probe exited it on that tier): the task occupies compute
    resources ``0..e`` and links ``0..e-1`` and never touches anything
    downstream.  ``early_exit`` is the legacy boolean spelling of
    ``exit_hop = 0`` (task runs only segment 0) and is kept in sync:
    after normalization it is True iff the task exits before the last
    segment.

    ``t_fixed[k]`` splits segment ``k``'s service time into a per-launch
    fixed part and a per-task marginal part for continuous micro-batching
    (calibrated from the per-layer utilization attainment gap in
    ``repro_torch.core.costs.segment_batch_split``): a batch of ``m >= 2``
    tasks occupies the tier for ``max_i t_fixed_i + sum_i t_marginal_i``
    where ``t_marginal = compute - t_fixed``.  A singleton batch costs
    exactly ``compute[k]``, so ``batch_cap = 1`` timelines are
    bit-identical to the unbatched replay by construction.  ``deadline``
    is the task's absolute staleness deadline (tenant SLO): batch
    formation never admits a follower that would push any member's
    finish past the tightest deadline in the batch."""
    compute: Tuple[float, ...]
    tx: Tuple[float, ...]
    tx_offset: Tuple[Optional[float], ...] = ()
    rx_offset: Tuple[Optional[float], ...] = ()
    early_exit: bool = False
    exit_hop: Optional[int] = None
    t_fixed: Tuple[float, ...] = ()
    deadline: Optional[float] = None

    def __post_init__(self):
        n_hops = len(self.tx)
        assert len(self.compute) == n_hops + 1, "need n_hops+1 compute stages"
        if not self.tx_offset:
            self.tx_offset = (None,) * n_hops
        if not self.rx_offset:
            self.rx_offset = (None,) * n_hops
        if not self.t_fixed:
            self.t_fixed = (0.0,) * (n_hops + 1)
        assert len(self.t_fixed) == n_hops + 1, "need n_hops+1 fixed costs"
        assert all(0.0 <= f <= c + 1e-12
                   for f, c in zip(self.t_fixed, self.compute)), \
            "t_fixed must stay within each segment's compute time"
        if self.early_exit and self.exit_hop is None:
            self.exit_hop = 0
        if self.exit_hop is not None:
            assert 0 <= self.exit_hop <= n_hops, \
                f"exit_hop {self.exit_hop} outside [0, {n_hops}]"
            if self.exit_hop == n_hops:   # "exit" at the cloud = full run
                self.exit_hop = None
        self.early_exit = self.exit_hop is not None

    @property
    def n_stages(self) -> int:
        """Number of compute segments the task actually runs."""
        return (self.exit_hop + 1) if self.exit_hop is not None \
            else len(self.compute)

    @property
    def t_marginal(self) -> Tuple[float, ...]:
        """Per-segment marginal (per-batch-member) service time."""
        return tuple(c - f for c, f in zip(self.compute, self.t_fixed))


# -------------------------------------------------- micro-batching semantics
def batched_service_time(plans: Sequence[SimPlan], k: int) -> float:
    """Tier occupancy of one micro-batch at segment ``k``.

    A singleton costs exactly its ``compute[k]`` (bit-identity with the
    unbatched replay); ``m >= 2`` members amortize the launch cost:
    ``max_i t_fixed_i[k] + sum_i (compute_i[k] - t_fixed_i[k])``.  Both
    the arithmetic simulator and the event-driven executor price batches
    through this one helper, so their float arithmetic is identical."""
    if len(plans) == 1:
        return plans[0].compute[k]
    return (max(p.t_fixed[k] for p in plans)
            + sum(p.compute[k] - p.t_fixed[k] for p in plans))


def greedy_batch_size(k: int, cap: int, s: float,
                      plans: Sequence[SimPlan],
                      ready: Sequence[float],
                      speed: float = 1.0) -> int:
    """Greedy drain-up-to-cap-or-deadline batch formation rule.

    ``plans[0]`` is the head task the worker woke up for; ``plans[1:]``
    are the tasks queued behind it in FIFO order, *snapshotted at the
    worker's wake instant* (items enqueued later never join this batch —
    the executor and the simulator must agree on the candidate set).
    ``s`` is the batch's service start; ``ready[i]`` is when task ``i``'s
    input data is ready at this tier.  Followers are admitted in FIFO
    order while (a) the cap is not exceeded, (b) the follower's data is
    ready by ``s``, and (c) the grown batch still finishes by the
    tightest deadline among its members (the head itself is never
    deadline-gated — it must run regardless).  The first failure stops
    formation, so a batch is always a FIFO prefix: batching never
    reorders tasks.

    ``speed`` scales the batch's service time for heterogeneous pool
    replicas (``PoolSpec.speeds``); the default 1.0 keeps the chain
    path's float arithmetic bit-identical (``s + 1.0 * t == s + t``)."""
    inf = float("inf")
    d0 = plans[0].deadline
    dmin = d0 if d0 is not None else inf
    n = 1
    while n < len(plans) and n < cap:
        p = plans[n]
        if ready[n] > s:
            break
        nd = min(dmin, p.deadline if p.deadline is not None else inf)
        if s + speed * batched_service_time(plans[:n + 1], k) > nd:
            break
        dmin = nd
        n += 1
    return n


@dataclasses.dataclass
class StreamResult:
    """Per-resource accounting of a simulated task stream.

    ``compute_intervals[k]`` / ``link_intervals[k]`` are the per-resource
    busy intervals (one ``(start, end)`` per task that occupied the
    resource, in admission order) — the raw timeline, exposed so an
    executor's recorded schedule can be compared against the simulator's
    interval by interval.

    ``early_exit[i]`` is True iff task ``i`` exited before the last
    segment; ``exit_hop[i]`` names the segment it terminated at (``None``
    = full pipeline).  Downstream of the exit, the task occupies nothing
    — use ``occupies_compute``/``occupies_link`` to map a resource's
    interval list back to the tasks that produced it.

    Under micro-batching a compute interval may serve several tasks at
    once: ``compute_batch_sizes[k][b]`` counts the occupying tasks served
    by ``compute_intervals[k][b]`` (consecutive in admission order).
    Empty means every interval is a singleton — the unbatched 1:1
    task-to-interval mapping.  Link transfers are never batched, so link
    intervals always stay 1:1."""
    arrivals: List[float]
    done: List[float]
    early_exit: List[bool]
    makespan: float
    compute_busy: Tuple[float, ...]
    link_busy: Tuple[float, ...]
    compute_intervals: Tuple[Tuple[Interval, ...], ...] = ()
    link_intervals: Tuple[Tuple[Interval, ...], ...] = ()
    exit_hop: List[Optional[int]] = dataclasses.field(default_factory=list)
    compute_batch_sizes: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self):
        if not self.exit_hop:
            self.exit_hop = [0 if e else None for e in self.early_exit]


def simulate_stream(plans: Sequence[SimPlan],
                    arrivals: Sequence[float],
                    links: Optional[Sequence[Optional[LinkProfile]]] = None,
                    batch_caps: Optional[Sequence[int]] = None,
                    sink=None,
                    ingress_enqueues: Optional[Sequence[float]] = None,
                    migrate=None
                    ) -> StreamResult:
    """Replay a task stream over the ``2n+1`` serial resources.

    Tasks are admitted in order; every resource is serial FIFO.  If
    ``links[k]`` carries a bandwidth trace, hop ``k``'s transfers are
    re-integrated at their actual start times (the planned duration is
    interpreted as a bit volume at the link's nominal bandwidth).

    A task with ``exit_hop = e`` terminates at segment ``e``: it runs
    compute ``0..e`` and links ``0..e-1`` and releases every downstream
    resource at the exit instant (hop-level semantic early exit).

    ``batch_caps[k]`` (one per compute segment) enables continuous
    micro-batching on tier ``k``: a free worker drains the tasks queued
    at its wake instant into one batch, bounded by the cap and by the
    members' staleness deadlines (``greedy_batch_size``), and the tier
    is occupied once for ``batched_service_time``.  ``None`` — or caps
    of all ones — replays the classic one-task-per-slot timeline.

    ``sink`` is an optional trace sink (``repro_torch.obs.trace``): when set,
    every enqueue/service/transfer/exit event is emitted as a span with
    exactly the instants of this timeline — the async executor emits the
    same spans, so traces are differentially pinned like results.  Every
    emission is guarded by ``sink is not None`` (zero cost disabled).
    ``ingress_enqueues[i]`` overrides the *reported* tier-0 enqueue
    instant of task ``i`` (the multi-tenant gate dispatches at ``t_d >=
    arrival``; the chain timeline is unaffected because the credit gate
    never delays a task past ``max(arrival, free_0)``).

    ``migrate(i, k, tx_ready) -> Optional[SimPlan]`` is the online
    re-planning hook (``repro_torch.scenarios``): it is consulted once per
    task per hop, at the instant the task's hop-``k`` boundary data is
    ready to transmit.  Returning a plan switches task ``i`` to it for
    the remainder of its pipeline — the hop-``k`` transfer (volume,
    offsets) and all downstream segments are priced under the new plan,
    while everything already replayed stays charged to the old one (a
    task completes its current segment under the old plan, then
    continues under the new cut/bits).  The hook's arguments depend
    only on the task's own timeline, never on a clock, so the async
    executor reaches identical migration decisions; the switch is
    recorded as a ``replan`` span.  The returned plan must preserve
    the task's hop count and exit hop.  Migration composes with the
    unbatched chain path only (no micro-batching, no pools)."""
    assert plans, "empty stream"
    if batch_caps is not None and any(c > 1 for c in batch_caps):
        assert migrate is None, \
            "plan migration composes with the unbatched chain path only"
        return _simulate_stream_batched(plans, arrivals, links, batch_caps,
                                        sink=sink,
                                        ingress_enqueues=ingress_enqueues)
    n_hops = len(plans[0].tx)
    n_seg = n_hops + 1
    compute_free = [0.0] * n_seg
    link_free = [0.0] * n_hops
    compute_busy = [0.0] * n_seg
    link_busy = [0.0] * n_hops
    compute_iv: List[List[Interval]] = [[] for _ in range(n_seg)]
    link_iv: List[List[Interval]] = [[] for _ in range(n_hops)]
    done: List[float] = []
    exits: List[bool] = []
    exit_hops: List[Optional[int]] = []
    enq_acc = 0.0
    for i, (p, arr) in enumerate(zip(plans, arrivals)):
        assert len(p.tx) == n_hops, "mixed hop counts in one stream"
        e = p.exit_hop if p.exit_hop is not None else n_hops
        s = max(arr, compute_free[0])
        d = s + p.compute[0]
        compute_free[0] = d
        compute_busy[0] += p.compute[0]
        compute_iv[0].append((s, d))
        exits.append(p.exit_hop is not None)
        exit_hops.append(p.exit_hop)
        if sink is not None:
            enq_acc = arr if arr > enq_acc else enq_acc
            e0 = ingress_enqueues[i] if ingress_enqueues is not None \
                else enq_acc
            sink.span(Span(ENQUEUE, ("compute", 0), e0, e0, task=i))
            sink.span(Span(SERVICE, ("compute", 0, 0), s, d, task=i,
                           tasks=(i,), ready=arr, batch=1))
        if e == 0:
            done.append(d)
            if sink is not None:
                sink.span(Span(EXIT_RELEASE, ("compute", 0, 0), d, d,
                               task=i, hop=0))
            continue
        prev_start, prev_done = s, d
        for k in range(e):
            off = p.tx_offset[k]
            tx_ready = prev_done if off is None or off >= p.compute[k] \
                else prev_start + off
            if migrate is not None:
                newp = migrate(i, k, tx_ready)
                if newp is not None:
                    assert len(newp.tx) == n_hops \
                        and newp.exit_hop == p.exit_hop, \
                        "migrated plan must preserve hop count and exit hop"
                    p = newp
                    if sink is not None:
                        sink.span(Span(REPLAN, ("link", k), tx_ready,
                                       tx_ready, task=i, hop=k))
            t_start = max(tx_ready, link_free[k])
            t_dur = p.tx[k]
            lk = links[k] if links is not None and k < len(links) else None
            if lk is not None and lk.trace is not None and t_dur > 0:
                # re-integrate the same bit volume under the live trace
                bits = t_dur * lk.bandwidth_bps
                t_dur = lk.transfer_time(bits, t_start)
            t_done = t_start + t_dur
            link_free[k] = t_done
            link_busy[k] += t_dur
            link_iv[k].append((t_start, t_done))
            roff = p.rx_offset[k]
            c_ready = t_done if roff is None \
                else max(t_start + roff, tx_ready)
            c_start = max(c_ready, compute_free[k + 1])
            # downstream compute cannot finish before all data has arrived
            c_done = max(c_start + p.compute[k + 1], t_done)
            compute_free[k + 1] = c_done
            compute_busy[k + 1] += p.compute[k + 1]
            compute_iv[k + 1].append((c_start, c_start + p.compute[k + 1]))
            if sink is not None:
                sink.span(Span(XFER, ("link", k), t_start, t_done,
                               task=i, ready=tx_ready))
                # next-tier enqueue = the executor link worker's put
                # instant (partial-forward under an rx offset)
                tq = t_start + min(max(c_ready - t_start, 0.0), t_dur)
                sink.span(Span(ENQUEUE, ("compute", k + 1), tq, tq, task=i))
                sink.span(Span(SERVICE, ("compute", k + 1, 0), c_start,
                               c_start + p.compute[k + 1], task=i,
                               tasks=(i,), ready=c_ready, batch=1))
            prev_start, prev_done = c_start, c_done
        done.append(prev_done)
        if sink is not None and p.exit_hop is not None:
            sink.span(Span(EXIT_RELEASE, ("compute", e, 0), prev_done,
                           prev_done, task=i, hop=e))
    arrivals = list(arrivals[:len(done)])
    makespan = max(done) - min(arrivals)
    return StreamResult(arrivals=arrivals, done=done, early_exit=exits,
                        makespan=makespan,
                        compute_busy=tuple(compute_busy),
                        link_busy=tuple(link_busy),
                        compute_intervals=tuple(tuple(iv) for iv in compute_iv),
                        link_intervals=tuple(tuple(iv) for iv in link_iv),
                        exit_hop=exit_hops)


def _simulate_stream_batched(
        plans: Sequence[SimPlan],
        arrivals: Sequence[float],
        links: Optional[Sequence[Optional[LinkProfile]]],
        batch_caps: Sequence[int],
        sink=None,
        ingress_enqueues: Optional[Sequence[float]] = None) -> StreamResult:
    """Staged replay of ``simulate_stream`` with per-tier micro-batching.

    Tiers are replayed one at a time (tier 0, link 0, tier 1, ...) —
    legal because tasks flow strictly forward, so a tier's inputs are
    fully determined by the previous link's outputs.  Each compute tier
    drains its pending tasks with the same greedy
    drain-up-to-cap-or-deadline rule the event-driven workers in
    ``repro_torch.serving.async_engine`` apply: batch membership is decided
    against the queue state at the worker's *wake* instant, service is
    priced by ``batched_service_time``, and exit-hop members leave the
    batch at their tier.  Members of a multi-task batch forward serially
    (the batch launch owns the tier until it completes, so the Fig. 4
    intra-task overlap offsets only apply to singleton batches).  With
    every cap at 1 the replay uses the same float expressions as the
    classic interleaved loop."""
    n_hops = len(plans[0].tx)
    n_seg = n_hops + 1
    caps = [int(batch_caps[k]) if k < len(batch_caps) else 1
            for k in range(n_seg)]
    assert all(c >= 1 for c in caps), "batch caps must be >= 1"
    for p in plans:
        assert len(p.tx) == n_hops, "mixed hop counts in one stream"
    # tier-0 batches gather same-instant arrivals, so batching the ingress
    # tier needs arrival order = admission order (deeper tiers see
    # monotone hand-off instants by construction, any arrival order)
    assert caps[0] <= 1 or all(
        a0 <= a1 for a0, a1 in zip(arrivals, arrivals[1:])), \
        "batching tier 0 needs non-decreasing arrivals (admission order)"
    compute_busy = [0.0] * n_seg
    link_busy = [0.0] * n_hops
    compute_iv: List[List[Interval]] = [[] for _ in range(n_seg)]
    comp_bs: List[List[int]] = [[] for _ in range(n_seg)]
    link_iv: List[List[Interval]] = [[] for _ in range(n_hops)]
    done: List[float] = [0.0] * len(plans)
    link_free = [0.0] * n_hops

    # pending task state entering the current tier, FIFO by admission:
    # (task index, queue-enqueue instant, input-ready instant, data-done)
    pend: List[Tuple[int, float, float, float]] = []
    enq = 0.0
    for i, arr in enumerate(arrivals):
        enq = arr if arr > enq else enq   # the admitter is serial
        pend.append((i, enq, float(arr), float(arr)))
        if sink is not None:
            e0 = ingress_enqueues[i] if ingress_enqueues is not None else enq
            sink.span(Span(ENQUEUE, ("compute", 0), e0, e0, task=i))

    for k in range(n_seg):
        cap = caps[k]
        free = 0.0
        nxt: List[Tuple[int, float]] = []   # (task index, tx_ready) -> link k
        i = 0
        while i < len(pend):
            idx0, enq0, ready0, dd0 = pend[i]
            wake = max(enq0, free)
            s = max(ready0, wake)
            n_b = 1
            if cap > 1:
                # candidate set = FIFO queue snapshot at the wake instant
                # (enqueue instants are non-decreasing, so it is a prefix)
                j = i + 1
                while j < len(pend) and pend[j][1] <= wake:
                    j += 1
                cand = pend[i:j]
                n_b = greedy_batch_size(
                    k, cap, s, [plans[e[0]] for e in cand],
                    [e[2] for e in cand])
            batch = pend[i:i + n_b]
            i += n_b
            if n_b == 1:
                p = plans[idx0]
                comp = p.compute[k]
                compute_busy[k] += comp
                compute_iv[k].append((s, s + comp))
                comp_bs[k].append(1)
                if sink is not None:
                    sink.span(Span(SERVICE, ("compute", k, 0), s, s + comp,
                                   task=idx0, tasks=(idx0,), ready=ready0,
                                   batch=1))
                fin = max(s + comp, dd0)
                free = fin
                if k == n_hops or (p.exit_hop is not None
                                   and k >= p.exit_hop):
                    done[idx0] = fin
                    if sink is not None and p.exit_hop is not None:
                        sink.span(Span(EXIT_RELEASE, ("compute", k, 0),
                                       fin, fin, task=idx0, hop=p.exit_hop))
                else:
                    off = p.tx_offset[k]
                    tx_ready = fin if off is None or off >= comp else s + off
                    nxt.append((idx0, tx_ready))
                continue
            dur = batched_service_time([plans[e[0]] for e in batch], k)
            compute_busy[k] += dur
            compute_iv[k].append((s, s + dur))
            comp_bs[k].append(n_b)
            if sink is not None:
                sink.span(Span(SERVICE, ("compute", k, 0), s, s + dur,
                               task=idx0,
                               tasks=tuple(e[0] for e in batch),
                               ready=ready0, batch=n_b))
                for (idx_m, _, ready_m, _) in batch[1:]:
                    if s > ready_m:
                        sink.span(Span(BATCH_FORM, ("compute", k, 0),
                                       ready_m, s, task=idx_m))
            end = s + dur
            fin = end
            for (idx_m, _, _, dd_m) in batch:
                p = plans[idx_m]
                fin = max(end, dd_m)   # data-done gates each completion
                if k == n_hops or (p.exit_hop is not None
                                   and k >= p.exit_hop):
                    done[idx_m] = fin
                    if sink is not None and p.exit_hop is not None:
                        sink.span(Span(EXIT_RELEASE, ("compute", k, 0),
                                       fin, fin, task=idx_m, hop=p.exit_hop))
                else:
                    nxt.append((idx_m, fin))
            free = fin

        if k == n_hops:
            break
        new_pend: List[Tuple[int, float, float, float]] = []
        for (idx, tx_ready) in nxt:
            p = plans[idx]
            t_start = max(tx_ready, link_free[k])
            t_dur = p.tx[k]
            lk = links[k] if links is not None and k < len(links) else None
            if lk is not None and lk.trace is not None and t_dur > 0:
                bits = t_dur * lk.bandwidth_bps
                t_dur = lk.transfer_time(bits, t_start)
            t_done = t_start + t_dur
            link_free[k] = t_done
            link_busy[k] += t_dur
            link_iv[k].append((t_start, t_done))
            roff = p.rx_offset[k]
            c_ready = t_done if roff is None \
                else max(t_start + roff, tx_ready)
            # the task reaches the next tier's queue the moment enough of
            # the tensor is across — the same instant (same float
            # expression) the executor's link worker performs its put
            fwd = min(max(c_ready - t_start, 0.0), t_dur)
            new_pend.append((idx, t_start + fwd, c_ready, t_done))
            if sink is not None:
                sink.span(Span(XFER, ("link", k), t_start, t_done,
                               task=idx, ready=tx_ready))
                sink.span(Span(ENQUEUE, ("compute", k + 1), t_start + fwd,
                               t_start + fwd, task=idx))
        pend = new_pend

    arr_list = list(arrivals)
    makespan = max(done) - min(arr_list)
    return StreamResult(arrivals=arr_list, done=done,
                        early_exit=[p.exit_hop is not None for p in plans],
                        makespan=makespan,
                        compute_busy=tuple(compute_busy),
                        link_busy=tuple(link_busy),
                        compute_intervals=tuple(tuple(iv) for iv in compute_iv),
                        link_intervals=tuple(tuple(iv) for iv in link_iv),
                        exit_hop=[p.exit_hop for p in plans],
                        compute_batch_sizes=tuple(tuple(b)
                                                  for b in comp_bs))


# ============================================================ multi-tenant
TenantSlot = Tuple[int, int]  # (tenant index, per-tenant task index)


def multitenant_admission_order(
        plans: Sequence[Sequence[SimPlan]],
        arrivals: Sequence[Sequence[float]],
        policy,
        sink=None,
        return_enqueues: bool = False):
    """Merge per-tenant FIFO streams into one global admission sequence.

    Admission is gated by the shared ingress resource (``compute_0``):
    each dispatch decision happens at ``t_d = max(free_0, earliest
    pending arrival)``, the *candidates* are the tenants whose head task
    has arrived by ``t_d``, and ``policy.pick(candidates, heads)``
    chooses among them (``heads[t] = (arrival, per-tenant index,
    SimPlan)``).  Within a tenant, tasks are admitted strictly in
    arrival (index) order — the policy only interleaves *across*
    tenants.

    ``policy`` is any object with ``reset(n_tenants)`` and
    ``pick(candidates, heads) -> tenant`` (the admission schedulers live
    in ``repro_torch.serving.tenancy``; the policy state machine is shared
    between this arithmetic gate and the executor's event-driven ingress
    credits, so the differential harness pins the *gating semantics*,
    not the policy code).

    ``sink`` emits a ``credit_wait`` span per dispatch held past its
    task's arrival (the executor's dispatcher emits the same span at its
    put instant).  ``return_enqueues=True`` additionally returns the
    per-slot dispatch instants ``t_d`` (the true tier-0 enqueue times,
    fed to ``simulate_stream(ingress_enqueues=...)`` for tracing).
    """
    n_t = len(plans)
    assert len(arrivals) == n_t
    for t in range(n_t):
        assert len(plans[t]) == len(arrivals[t]), f"tenant {t} length mismatch"
        assert all(a0 <= a1 for a0, a1 in zip(arrivals[t], arrivals[t][1:])), \
            f"tenant {t} arrivals must be non-decreasing"
    total = sum(len(p) for p in plans)
    heads = [0] * n_t
    free0 = 0.0
    order: List[TenantSlot] = []
    enqueues: List[float] = []
    policy.reset(n_t)
    while len(order) < total:
        pend = [t for t in range(n_t) if heads[t] < len(plans[t])]
        t_min = min(arrivals[t][heads[t]] for t in pend)
        t_d = max(free0, t_min)
        cands = [t for t in pend if arrivals[t][heads[t]] <= t_d]
        info = {t: (arrivals[t][heads[t]], heads[t], plans[t][heads[t]])
                for t in cands}
        t = policy.pick(cands, info)
        assert t in info, f"policy picked non-candidate tenant {t}"
        i = heads[t]
        heads[t] += 1
        if sink is not None and t_d > arrivals[t][i]:
            sink.span(Span(CREDIT_WAIT, ("compute", 0), arrivals[t][i],
                           t_d, task=len(order)))
        order.append((t, i))
        enqueues.append(t_d)
        free0 = max(arrivals[t][i], free0) + plans[t][i].compute[0]
    return (order, enqueues) if return_enqueues else order


@dataclasses.dataclass
class MultiTenantStreamResult:
    """A merged multi-tenant timeline plus its tenant tagging.

    ``stream`` is the merged-stream result in admission order;
    ``order[j]`` names the tenant and per-tenant task index occupying
    global slot ``j``.  ``n_tenants`` is the declared tenant count (not
    derived from ``order`` — a tenant that admitted zero tasks still
    counts).  Per-resource busy intervals follow the same slot order
    (a resource's interval list only contains the slots that occupy it —
    a task exiting at segment ``e`` occupies compute ``0..e`` and links
    ``0..e-1``; see ``occupies_compute``/``occupies_link``), so an
    executor's recorded multi-tenant schedule can be compared per tenant
    as well as per resource."""
    stream: StreamResult
    order: Tuple[TenantSlot, ...]
    n_tenants: int = 0

    def tenant_slots(self, tenant: int) -> List[int]:
        """Global slot indices occupied by ``tenant``, in admission
        (= per-tenant FIFO) order."""
        return [j for j, (t, _) in enumerate(self.order) if t == tenant]

    def tenant_view(self, tenant: int
                    ) -> Tuple[List[float], List[float], List[bool]]:
        """``(arrivals, done, early_exit)`` of one tenant's tasks, in
        per-tenant order."""
        s = self.stream
        slots = self.tenant_slots(tenant)
        return ([s.arrivals[j] for j in slots], [s.done[j] for j in slots],
                [s.early_exit[j] for j in slots])

    def tenant_exit_hops(self, tenant: int) -> List[Optional[int]]:
        """Per-task exit hops of one tenant, in per-tenant order."""
        return [self.stream.exit_hop[j] for j in self.tenant_slots(tenant)]

    def tenant_latencies(self, tenant: int) -> List[float]:
        arr, done, _ = self.tenant_view(tenant)
        return [d - a for a, d in zip(arr, done)]


def simulate_multitenant_stream(
        plans: Sequence[Sequence[SimPlan]],
        arrivals: Sequence[Sequence[float]],
        policy,
        links: Optional[Sequence[Optional[LinkProfile]]] = None,
        batch_caps: Optional[Sequence[int]] = None,
        sink=None,
        migrate=None
        ) -> MultiTenantStreamResult:
    """Replay tagged multi-tenant task streams over the shared ``2n+1``
    resources: compute the policy's admission order (gated by the
    ingress resource), then replay the merged stream with
    ``simulate_stream``.  This is the reference timeline the async
    multi-tenant executor is pinned to.

    ``batch_caps`` enables per-tier micro-batching on the merged stream.
    The ingress tier's cap is forced to 1: multi-tenant admission is
    credit-gated one task at a time (the dispatcher holds the next task
    until ``compute_0`` frees), so the ingress queue never holds more
    than one task and batching there would diverge from the admission
    gate both engines implement."""
    order, enqueues = multitenant_admission_order(plans, arrivals, policy,
                                                  sink=sink,
                                                  return_enqueues=True)
    assert order, "empty multi-tenant stream"
    merged_plans = [plans[t][i] for (t, i) in order]
    merged_arr = [arrivals[t][i] for (t, i) in order]
    if batch_caps is not None:
        batch_caps = [1] + [int(c) for c in batch_caps[1:]]
    res = simulate_stream(merged_plans, merged_arr, links=links,
                          batch_caps=batch_caps, sink=sink,
                          ingress_enqueues=enqueues, migrate=migrate)
    return MultiTenantStreamResult(stream=res, order=tuple(order),
                                   n_tenants=len(plans))


# ============================================================ resource pools
@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """One tier as a pool of ``m = len(speeds)`` replica resources.

    ``speeds[r]`` is replica ``r``'s service-time multiplier: a plan's
    segment-``k`` occupation on replica ``r`` costs
    ``speeds[r] * plan.compute[k]`` (so 1.0 is the chain's reference
    device, 2.0 a half-speed replica, 0.5 a double-speed one).  A pool
    of one unit-speed replica is exactly the chain's serial resource —
    ``simulate_pool_stream`` over all-``m=1`` unit pools is bit-identical
    to ``simulate_stream`` (tested)."""
    speeds: Tuple[float, ...] = (1.0,)

    def __post_init__(self):
        object.__setattr__(self, "speeds",
                           tuple(float(s) for s in self.speeds))
        assert self.speeds, "a pool needs at least one replica"
        assert all(s > 0.0 for s in self.speeds), \
            "replica speed multipliers must be positive"

    @property
    def m(self) -> int:
        return len(self.speeds)


def as_pools(pools, n_seg: int) -> Tuple[PoolSpec, ...]:
    """Normalize a per-tier pool description into ``PoolSpec`` tuples.

    Each entry may be a ``PoolSpec``, an ``int`` replica count (unit
    speeds), or a sequence of speed multipliers.  Missing tail entries
    default to a single unit-speed replica (the chain resource)."""
    out: List[PoolSpec] = []
    for k in range(n_seg):
        p = pools[k] if pools is not None and k < len(pools) else 1
        if isinstance(p, PoolSpec):
            out.append(p)
        elif isinstance(p, int):
            assert p >= 1, "replica count must be >= 1"
            out.append(PoolSpec(speeds=(1.0,) * p))
        else:
            out.append(PoolSpec(speeds=tuple(float(s) for s in p)))
    return tuple(out)


@dataclasses.dataclass
class PoolStreamResult:
    """Per-replica accounting of a stream replayed over resource pools.

    The tier-level lists of ``StreamResult`` split per replica:
    ``replica_intervals[k][r]`` / ``replica_busy[k][r]`` /
    ``replica_batch_sizes[k][r]`` describe replica ``r`` of tier ``k``
    (links stay serial, one per hop).  ``routes[i][k]`` names the replica
    task ``i`` ran on at tier ``k`` (``None`` = the task never reached
    that tier, i.e. it exited upstream).  ``as_stream_result()`` merges
    the per-replica timelines back into the tier-level ``StreamResult``
    shape for metric code that does not care about placement."""
    arrivals: List[float]
    done: List[float]
    early_exit: List[bool]
    exit_hop: List[Optional[int]]
    makespan: float
    link_busy: Tuple[float, ...]
    link_intervals: Tuple[Tuple[Interval, ...], ...]
    replica_busy: Tuple[Tuple[float, ...], ...]
    replica_intervals: Tuple[Tuple[Tuple[Interval, ...], ...], ...]
    replica_batch_sizes: Tuple[Tuple[Tuple[int, ...], ...], ...]
    routes: Tuple[Tuple[Optional[int], ...], ...]
    pools: Tuple[PoolSpec, ...] = ()

    @property
    def compute_busy(self) -> Tuple[float, ...]:
        """Tier-level busy time: sum over the tier's replicas."""
        return tuple(sum(rb) for rb in self.replica_busy)

    def as_stream_result(self) -> StreamResult:
        """Tier-level view: per-tier intervals merged across replicas in
        start-time order (stable by replica index), batch sizes carried
        along; emitted batch sizes only when some batch held > 1 task,
        matching ``simulate_stream``'s empty-means-singletons convention."""
        comp_iv: List[Tuple[Interval, ...]] = []
        comp_bs: List[Tuple[int, ...]] = []
        for k in range(len(self.replica_intervals)):
            tagged = []
            for r, ivs in enumerate(self.replica_intervals[k]):
                bss = self.replica_batch_sizes[k][r]
                for iv, bs in zip(ivs, bss):
                    tagged.append((iv[0], iv[1], r, bs))
            tagged.sort(key=lambda t: (t[0], t[1], t[2]))
            comp_iv.append(tuple((t[0], t[1]) for t in tagged))
            comp_bs.append(tuple(t[3] for t in tagged))
        batched = any(b > 1 for bs in comp_bs for b in bs)
        return StreamResult(
            arrivals=list(self.arrivals), done=list(self.done),
            early_exit=list(self.early_exit), makespan=self.makespan,
            compute_busy=self.compute_busy, link_busy=self.link_busy,
            compute_intervals=tuple(comp_iv),
            link_intervals=self.link_intervals,
            exit_hop=list(self.exit_hop),
            compute_batch_sizes=tuple(comp_bs) if batched else ())


def simulate_pool_stream(plans: Sequence[SimPlan],
                         arrivals: Sequence[float],
                         pools,
                         router,
                         links: Optional[Sequence[Optional[LinkProfile]]] = None,
                         batch_caps: Optional[Sequence[int]] = None,
                         tenants: Optional[Sequence[Optional[int]]] = None,
                         enqueues: Optional[Sequence[float]] = None,
                         sink=None
                         ) -> PoolStreamResult:
    """Replay a task stream over a DAG of per-tier *resource pools*.

    Generalizes ``simulate_stream``: tier ``k`` is ``pools[k].m`` replica
    resources (heterogeneous ``speeds`` allowed) behind a router; links
    stay serial FIFO.  ``router`` is any object with ``reset(pools)`` and
    ``route(k, ready, compute, tenant) -> replica`` (the policies live in
    ``repro_torch.serving.routing``; like the admission policies, the state
    machine is shared with the executor so the differential harness pins
    the routing *semantics*).  Routing decisions are made at
    enqueue/arrival time in per-stream order, and router state is kept
    strictly per tier, so the executor's interleaving of tiers in wall
    time reaches identical decisions to this tier-by-tier staged replay.

    Per tier the staged replay is: (1) *dispatch* — route every pending
    task, in admission order, to a replica; (2) *replica replay* — each
    replica drains its own FIFO sub-queue under the chain's batching rule
    (``greedy_batch_size`` with the replica's ``speed``); (3)
    *sequencer* — completed tasks are forwarded to the hop link in
    admission order, each at the running max of the release instants so
    far (the executor's per-pool sequencer worker realizes the same
    merge); (4) *link* — the serial hop link replays exactly as in
    ``simulate_stream``.  With every pool at ``m = 1`` and unit speed,
    every expression reduces to the chain path's — bit-identical
    timelines (tested).

    ``tenants[i]`` tags task ``i`` for tenant-affinity routing;
    ``enqueues[i]`` overrides task ``i``'s tier-0 enqueue instant (used
    by the credit-gated multi-tenant admission; both must be
    non-decreasing — admission order)."""
    assert plans, "empty stream"
    n_hops = len(plans[0].tx)
    n_seg = n_hops + 1
    pools = as_pools(pools, n_seg)
    caps = [int(batch_caps[k]) if batch_caps is not None
            and k < len(batch_caps) else 1 for k in range(n_seg)]
    assert all(c >= 1 for c in caps), "batch caps must be >= 1"
    for p in plans:
        assert len(p.tx) == n_hops, "mixed hop counts in one stream"
    if tenants is None:
        tenants = [None] * len(plans)
    assert len(tenants) == len(plans)
    if enqueues is None:
        assert all(a0 <= a1 for a0, a1 in zip(arrivals, arrivals[1:])), \
            "pool streams need non-decreasing arrivals (admission order)"
    else:
        assert len(enqueues) == len(plans)
        assert all(e0 <= e1 for e0, e1 in zip(enqueues, enqueues[1:])), \
            "enqueue instants must be non-decreasing (admission order)"
    router.reset(pools)

    replica_busy: List[List[float]] = [[0.0] * p.m for p in pools]
    replica_iv: List[List[List[Interval]]] = \
        [[[] for _ in range(p.m)] for p in pools]
    replica_bs: List[List[List[int]]] = \
        [[[] for _ in range(p.m)] for p in pools]
    link_busy = [0.0] * n_hops
    link_iv: List[List[Interval]] = [[] for _ in range(n_hops)]
    link_free = [0.0] * n_hops
    done: List[float] = [0.0] * len(plans)
    routes: List[List[Optional[int]]] = [[None] * n_seg for _ in plans]

    # pending task state entering the current tier, FIFO by admission:
    # (task index, queue-enqueue instant, input-ready instant, data-done)
    pend: List[Tuple[int, float, float, float]] = []
    enq = 0.0
    for i, arr in enumerate(arrivals):
        if enqueues is not None:
            enq = float(enqueues[i])
        else:
            enq = arr if arr > enq else enq   # the admitter is serial
        pend.append((i, enq, float(arr), float(arr)))
        if sink is not None:
            sink.span(Span(ENQUEUE, ("compute", 0), enq, enq, task=i))

    for k in range(n_seg):
        cap = caps[k]
        m = pools[k].m
        speeds = pools[k].speeds
        # ---- dispatch: the pool's router assigns every pending task to a
        # replica, in admission order (the executor's dispatcher worker
        # makes the same calls, in the same order, on the same state)
        assign: List[List[Tuple[int, float, float, float]]] = \
            [[] for _ in range(m)]
        for seq_j, ent in enumerate(pend):
            r = router.route(k, ent[2], plans[ent[0]].compute[k],
                             tenants[ent[0]])
            assert 0 <= r < m, f"router placed task on replica {r} of {m}"
            routes[ent[0]][k] = r
            assign[r].append(ent)
            if sink is not None:
                sink.span(Span(ROUTE, ("compute", k, r), ent[2], ent[2],
                               task=ent[0], ready=ent[2], replica=r,
                               seq=seq_j))
        # ---- replica replay: each replica drains its own FIFO sub-queue
        # under the chain's drain-up-to-cap-or-deadline batching rule
        # release[idx] = (release instant, tx_ready | None if terminal)
        release: Dict[int, Tuple[float, Optional[float]]] = {}
        for r in range(m):
            speed = speeds[r]
            sub = assign[r]
            free = 0.0
            i = 0
            while i < len(sub):
                idx0, enq0, ready0, dd0 = sub[i]
                wake = max(enq0, free)
                s = max(ready0, wake)
                n_b = 1
                if cap > 1:
                    j = i + 1
                    while j < len(sub) and sub[j][1] <= wake:
                        j += 1
                    cand = sub[i:j]
                    n_b = greedy_batch_size(
                        k, cap, s, [plans[e[0]] for e in cand],
                        [e[2] for e in cand], speed=speed)
                batch = sub[i:i + n_b]
                i += n_b
                if n_b == 1:
                    p = plans[idx0]
                    comp = speed * p.compute[k]
                    replica_busy[k][r] += comp
                    replica_iv[k][r].append((s, s + comp))
                    replica_bs[k][r].append(1)
                    if sink is not None:
                        sink.span(Span(SERVICE, ("compute", k, r), s,
                                       s + comp, task=idx0, tasks=(idx0,),
                                       ready=ready0, batch=1))
                    fin = max(s + comp, dd0)
                    free = fin
                    if k == n_hops or (p.exit_hop is not None
                                       and k >= p.exit_hop):
                        done[idx0] = fin
                        release[idx0] = (fin, None)
                        if sink is not None and p.exit_hop is not None:
                            sink.span(Span(EXIT_RELEASE, ("compute", k, r),
                                           fin, fin, task=idx0,
                                           hop=p.exit_hop))
                    else:
                        off = p.tx_offset[k]
                        tx_ready = fin if off is None or off >= comp \
                            else s + off
                        release[idx0] = (tx_ready, tx_ready)
                    continue
                dur = speed * batched_service_time(
                    [plans[e[0]] for e in batch], k)
                replica_busy[k][r] += dur
                replica_iv[k][r].append((s, s + dur))
                replica_bs[k][r].append(n_b)
                if sink is not None:
                    sink.span(Span(SERVICE, ("compute", k, r), s, s + dur,
                                   task=idx0,
                                   tasks=tuple(e[0] for e in batch),
                                   ready=ready0, batch=n_b))
                    for (idx_m, _, ready_m, _) in batch[1:]:
                        if s > ready_m:
                            sink.span(Span(BATCH_FORM, ("compute", k, r),
                                           ready_m, s, task=idx_m))
                end = s + dur
                fin = end
                for (idx_m, _, _, dd_m) in batch:
                    p = plans[idx_m]
                    fin = max(end, dd_m)   # data-done gates each completion
                    if k == n_hops or (p.exit_hop is not None
                                       and k >= p.exit_hop):
                        done[idx_m] = fin
                        release[idx_m] = (fin, None)
                        if sink is not None and p.exit_hop is not None:
                            sink.span(Span(EXIT_RELEASE, ("compute", k, r),
                                           fin, fin, task=idx_m,
                                           hop=p.exit_hop))
                    else:
                        release[idx_m] = (fin, fin)
                free = fin

        if k == n_hops:
            break
        # ---- sequencer: restore admission order toward the serial link.
        # A task can go on the wire only once every earlier task has been
        # released by its replica (forwarded or declared terminal), so its
        # hand-off instant is the running max of release instants — on an
        # m=1 unit pool releases are already monotone and this is the
        # identity (bitwise chain equivalence).
        fwd = 0.0
        nxt: List[Tuple[int, float, float]] = []
        for ent in pend:
            rel, tx_ready = release[ent[0]]
            fwd = rel if rel > fwd else fwd
            if tx_ready is not None:
                nxt.append((ent[0], tx_ready, fwd))
                if sink is not None and fwd > rel:
                    sink.span(Span(SEQ_HOLD, ("link", k), rel, fwd,
                                   task=ent[0]))
        # ---- link k: serial FIFO, same expressions as simulate_stream
        new_pend: List[Tuple[int, float, float, float]] = []
        for (idx, tx_ready, fwd_j) in nxt:
            p = plans[idx]
            t_start = max(tx_ready, fwd_j, link_free[k])
            t_dur = p.tx[k]
            lk = links[k] if links is not None and k < len(links) else None
            if lk is not None and lk.trace is not None and t_dur > 0:
                bits = t_dur * lk.bandwidth_bps
                t_dur = lk.transfer_time(bits, t_start)
            t_done = t_start + t_dur
            link_free[k] = t_done
            link_busy[k] += t_dur
            link_iv[k].append((t_start, t_done))
            roff = p.rx_offset[k]
            c_ready = t_done if roff is None \
                else max(t_start + roff, tx_ready)
            fwd_frac = min(max(c_ready - t_start, 0.0), t_dur)
            new_pend.append((idx, t_start + fwd_frac, c_ready, t_done))
            if sink is not None:
                sink.span(Span(XFER, ("link", k), t_start, t_done,
                               task=idx, ready=tx_ready))
                sink.span(Span(ENQUEUE, ("compute", k + 1),
                               t_start + fwd_frac, t_start + fwd_frac,
                               task=idx))
        pend = new_pend

    arr_list = list(arrivals)
    makespan = max(done) - min(arr_list)
    return PoolStreamResult(
        arrivals=arr_list, done=done,
        early_exit=[p.exit_hop is not None for p in plans],
        exit_hop=[p.exit_hop for p in plans],
        makespan=makespan,
        link_busy=tuple(link_busy),
        link_intervals=tuple(tuple(iv) for iv in link_iv),
        replica_busy=tuple(tuple(rb) for rb in replica_busy),
        replica_intervals=tuple(tuple(tuple(iv) for iv in tier)
                                for tier in replica_iv),
        replica_batch_sizes=tuple(tuple(tuple(bs) for bs in tier)
                                  for tier in replica_bs),
        routes=tuple(tuple(rt) for rt in routes),
        pools=pools)


def multitenant_pool_admission(
        plans: Sequence[Sequence[SimPlan]],
        arrivals: Sequence[Sequence[float]],
        policy,
        pools,
        router,
        sink=None) -> Tuple[List[TenantSlot], List[float]]:
    """Pool-ingress admission gate: merge per-tenant streams gated by
    *pool* ingress credits.

    Generalizes ``multitenant_admission_order`` from one ingress resource
    to a tier-0 pool of ``m`` replicas: a credit is a token issued the
    moment *any* tier-0 replica frees, so up to ``m`` tasks are in flight
    at the ingress at once.  Arithmetically the credit pool is a min-heap
    of completion instants seeded with ``m`` zeros (the executor's
    replicas each put one credit before their first get and one at every
    completion): each dispatch pops the earliest credit ``c`` and happens
    at ``t_d = max(c, earliest pending arrival)``; the admitted head is
    routed (``router.route`` on tier 0 — the same call sequence the
    replay and the executor's dispatcher make), and the task's completion
    on its replica is pushed back as the next credit.

    Returns ``(order, enqueues)``: the admission sequence plus each
    task's dispatch instant ``t_d`` — the replay needs it because under
    affinity-style routing a task can be held by the credit gate past its
    routed replica's free instant."""
    n_t = len(plans)
    assert len(arrivals) == n_t
    for t in range(n_t):
        assert len(plans[t]) == len(arrivals[t]), f"tenant {t} length mismatch"
        assert all(a0 <= a1 for a0, a1 in zip(arrivals[t], arrivals[t][1:])), \
            f"tenant {t} arrivals must be non-decreasing"
    n_seg = len(plans[0][0].compute) if plans and plans[0] else 1
    pools = as_pools(pools, n_seg)
    router.reset(pools)
    speeds = pools[0].speeds
    credits = [0.0] * pools[0].m
    heapq.heapify(credits)
    free0 = [0.0] * pools[0].m
    total = sum(len(p) for p in plans)
    heads = [0] * n_t
    order: List[TenantSlot] = []
    enqueues: List[float] = []
    policy.reset(n_t)
    while len(order) < total:
        pend = [t for t in range(n_t) if heads[t] < len(plans[t])]
        t_min = min(arrivals[t][heads[t]] for t in pend)
        c = heapq.heappop(credits)
        t_d = max(c, t_min)
        cands = [t for t in pend if arrivals[t][heads[t]] <= t_d]
        info = {t: (arrivals[t][heads[t]], heads[t], plans[t][heads[t]])
                for t in cands}
        t = policy.pick(cands, info)
        assert t in info, f"policy picked non-candidate tenant {t}"
        i = heads[t]
        heads[t] += 1
        if sink is not None and t_d > arrivals[t][i]:
            sink.span(Span(CREDIT_WAIT, ("compute", 0), arrivals[t][i],
                           t_d, task=len(order)))
        order.append((t, i))
        enqueues.append(t_d)
        arr = arrivals[t][i]
        p = plans[t][i]
        r = router.route(0, arr, p.compute[0], t)
        # same float expressions as the replay's tier-0 replica:
        # wake = max(enq, free), s = max(ready, wake), fin = s + speed*c
        s = max(arr, max(t_d, free0[r]))
        fin = s + speeds[r] * p.compute[0]
        free0[r] = fin
        heapq.heappush(credits, fin)
    return order, enqueues


@dataclasses.dataclass
class MultiTenantPoolStreamResult(MultiTenantStreamResult):
    """Multi-tenant result over pooled tiers: the tenant-tagged
    tier-level view (``stream`` is the merged ``as_stream_result()``)
    plus the per-replica pool timeline in ``pool``."""
    pool: Optional[PoolStreamResult] = None


def simulate_multitenant_pool_stream(
        plans: Sequence[Sequence[SimPlan]],
        arrivals: Sequence[Sequence[float]],
        policy,
        pools,
        router,
        links: Optional[Sequence[Optional[LinkProfile]]] = None,
        batch_caps: Optional[Sequence[int]] = None,
        sink=None
        ) -> MultiTenantPoolStreamResult:
    """Replay tagged multi-tenant streams over pooled tiers: compute the
    pool-credit admission order, then replay the merged tenant-tagged
    stream with ``simulate_pool_stream``.  The ingress tier's batch cap
    is forced to 1 — admission stays credit-gated one task per credit —
    but every tier-0 *replica* still admits independently, so ingress
    throughput scales with the pool."""
    order, enqueues = multitenant_pool_admission(
        plans, arrivals, policy, pools, router, sink=sink)
    assert order, "empty multi-tenant stream"
    merged_plans = [plans[t][i] for (t, i) in order]
    merged_arr = [arrivals[t][i] for (t, i) in order]
    merged_tenants = [t for (t, _) in order]
    if batch_caps is not None:
        batch_caps = [1] + [int(c) for c in batch_caps[1:]]
    res = simulate_pool_stream(merged_plans, merged_arr, pools, router,
                               links=links, batch_caps=batch_caps,
                               tenants=merged_tenants, enqueues=enqueues,
                               sink=sink)
    return MultiTenantPoolStreamResult(stream=res.as_stream_result(),
                                       order=tuple(order),
                                       n_tenants=len(plans), pool=res)
