"""Continuous-task pipeline executor (discrete-event).

``2n+1`` serial resources — end device, per-hop links, intermediate edge
tiers, cloud — process a stream of tasks (Fig. 2); the paper's 3-resource
testbed is ``n_hops = 1``.  Per task the stage durations come from the
offline partition's ``StageTimes``; the online component may override
transmission bits (adaptive quantization) or skip everything past the end
device (early exit).  Intra-task layer parallelism is honoured through
per-hop tx/rx offsets measured by the single-task event simulation (Fig. 4
virtual-block overlap).  The event loop itself lives in
``repro_torch.core.sim.simulate_stream`` — the same core that scores offline
partitions — so planning and replay share one semantics.

Outputs latency, throughput, and explicit per-resource bubble accounting
(idle time within the active window) — the quantities COACH is designed to
minimize.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import sim
from repro_torch.core.costs import LinkProfile
from repro_torch.core.schedule import StageTimes


@dataclasses.dataclass
class TaskPlan:
    """Per-task pipeline occupation.

    The classic 3-stage form sets ``t_end``/``t_tx``/``t_cloud`` (+
    optional overlap offsets); ``multihop`` builds the general form whose
    per-segment/per-hop durations live in ``compute``/``tx``.  Offsets
    express intra-task overlap measured by the single-task event
    simulation (Fig. 4); ``None`` means strictly serial stages.

    ``exit_hop = e`` marks a hop-level semantic early exit at segment
    ``e`` (the task runs compute ``0..e`` and links ``0..e-1`` only);
    ``early_exit`` is the legacy boolean spelling of ``exit_hop = 0``.

    ``t_fixed`` (one per segment the plan declares) is the per-launch
    fixed part of each segment's service time for continuous
    micro-batching, and ``deadline`` the task's absolute staleness
    deadline — both forwarded to ``sim.SimPlan`` (see its docstring)."""
    t_end: float
    t_tx: float
    t_cloud: float
    early_exit: bool = False
    tx_offset: Optional[float] = None    # end-start -> tx can start
    cloud_offset: Optional[float] = None  # tx-start  -> cloud can start
    # ---- generalized N-hop form (empty => classic 3-stage)
    compute: Tuple[float, ...] = ()
    tx: Tuple[float, ...] = ()
    tx_offsets: Tuple[Optional[float], ...] = ()
    rx_offsets: Tuple[Optional[float], ...] = ()
    exit_hop: Optional[int] = None
    # ---- continuous micro-batching (empty / None = unbatched semantics)
    t_fixed: Tuple[float, ...] = ()
    deadline: Optional[float] = None

    @classmethod
    def multihop(cls, compute: Sequence[float], tx: Sequence[float],
                 tx_offsets: Optional[Sequence[Optional[float]]] = None,
                 rx_offsets: Optional[Sequence[Optional[float]]] = None,
                 early_exit: bool = False,
                 exit_hop: Optional[int] = None,
                 t_fixed: Optional[Sequence[float]] = None,
                 deadline: Optional[float] = None) -> "TaskPlan":
        compute, tx = tuple(compute), tuple(tx)
        assert len(compute) == len(tx) + 1
        return cls(t_end=compute[0], t_tx=tx[0] if tx else 0.0,
                   t_cloud=compute[-1], early_exit=early_exit,
                   compute=compute, tx=tx,
                   tx_offsets=tuple(tx_offsets) if tx_offsets else (None,) * len(tx),
                   rx_offsets=tuple(rx_offsets) if rx_offsets else (None,) * len(tx),
                   exit_hop=exit_hop,
                   t_fixed=tuple(t_fixed) if t_fixed else (),
                   deadline=deadline)

    @property
    def n_hops(self) -> int:
        return len(self.tx) if self.tx else 1

    def as_sim_plan(self, n_hops: int) -> sim.SimPlan:
        """Normalize to ``n_hops`` stages (shorter plans pad with zeros —
        an early-exited or shallower task simply never occupies the extra
        resources)."""
        if self.compute:
            comp, tx = list(self.compute), list(self.tx)
            txo, rxo = list(self.tx_offsets), list(self.rx_offsets)
        else:
            comp, tx = [self.t_end, self.t_cloud], [self.t_tx]
            txo, rxo = [self.tx_offset], [self.cloud_offset]
        fixed = list(self.t_fixed[:len(comp)]) if self.t_fixed else []
        if fixed:
            fixed += [0.0] * (len(comp) - len(fixed))
        while len(tx) < n_hops:
            tx.append(0.0)
            comp.append(0.0)
            txo.append(None)
            rxo.append(None)
            if fixed:
                fixed.append(0.0)
        return sim.SimPlan(compute=tuple(comp), tx=tuple(tx),
                           tx_offset=tuple(txo), rx_offset=tuple(rxo),
                           early_exit=self.early_exit,
                           exit_hop=self.exit_hop,
                           t_fixed=tuple(fixed),
                           deadline=self.deadline)


@dataclasses.dataclass
class TaskRecord:
    id: int
    arrival: float
    done: float
    latency: float
    early_exit: bool                      # exited before the last segment
    exit_hop: Optional[int] = None        # segment it terminated at


@dataclasses.dataclass
class PipelineResult:
    tasks: List[TaskRecord]
    makespan: float
    compute_busy: Tuple[float, ...]
    link_busy_hops: Tuple[float, ...]
    # per-resource busy intervals (from sim.StreamResult / the async
    # executor's recorded timeline) — empty tuples when not recorded
    compute_intervals: Tuple[Tuple[sim.Interval, ...], ...] = ()
    link_intervals: Tuple[Tuple[sim.Interval, ...], ...] = ()
    # replicas per compute tier when the run used replicated pools
    # (() = classic single-replica chain); compute_busy[k] then sums the
    # tier's replicas, so utilization is against m * makespan
    pool_sizes: Tuple[int, ...] = ()

    # ---- classic 3-resource views
    @property
    def end_busy(self) -> float:
        return self.compute_busy[0]

    @property
    def link_busy(self) -> float:
        return float(sum(self.link_busy_hops))

    @property
    def cloud_busy(self) -> float:
        return self.compute_busy[-1]

    @property
    def n_hops(self) -> int:
        return len(self.link_busy_hops)

    @property
    def mean_latency(self) -> float:
        return float(np.mean([t.latency for t in self.tasks]))

    @property
    def p99_latency(self) -> float:
        return float(np.percentile([t.latency for t in self.tasks], 99))

    @property
    def throughput(self) -> float:
        return len(self.tasks) / self.makespan if self.makespan > 0 else 0.0

    @property
    def exit_ratio(self) -> float:
        return float(np.mean([t.early_exit for t in self.tasks]))

    def exit_hop_counts(self) -> dict:
        """Histogram of hop-level exits: ``{segment: task count}`` over
        the tasks that exited before the last segment."""
        counts: dict = {}
        for t in self.tasks:
            if t.exit_hop is not None:
                counts[t.exit_hop] = counts.get(t.exit_hop, 0) + 1
        return dict(sorted(counts.items()))

    def stage_busy(self, stage: Union[str, Tuple[str, int]]) -> float:
        """Busy time of one resource: "end"/"link"/"cloud" (classic view)
        or ("compute", k) / ("link", k) for the general pipeline."""
        if isinstance(stage, tuple):
            kind, k = stage
            return self.compute_busy[k] if kind == "compute" \
                else self.link_busy_hops[k]
        return {"end": self.end_busy, "link": self.link_busy,
                "cloud": self.cloud_busy}[stage]

    def _capacity(self, stage: Union[str, Tuple[str, int]]) -> float:
        """Busy-time capacity of a resource over the run: ``makespan``
        for a serial resource, ``m * makespan`` for a replicated compute
        tier, ``n_hops * makespan`` for the aggregate ``"link"`` view
        (``link_busy`` sums every hop) — so ``bubble_fraction`` stays in
        ``[0, 1]`` with pools and with multi-hop chains alike.

        Replica *speeds* need no extra normalization: busy time is
        measured in wall seconds on each replica (a slow replica is busy
        longer for the same task), so ``m * makespan`` is the correct
        wall-clock capacity of a heterogeneous pool too.  This matches
        the per-resource conservation identity of
        ``repro_torch.obs.bubbles.attribute`` — ``sum_r busy_r + sum_r
        bubbles_r = m * horizon`` per tier."""
        if stage == "link":
            return self.n_hops * self.makespan
        if not self.pool_sizes:
            return self.makespan
        if isinstance(stage, tuple):
            kind, k = stage
            return self.pool_sizes[k] * self.makespan \
                if kind == "compute" else self.makespan
        if stage == "end":
            return self.pool_sizes[0] * self.makespan
        if stage == "cloud":
            return self.pool_sizes[-1] * self.makespan
        return self.makespan

    def bubble_fraction(self, stage: Union[str, Tuple[str, int]] = "cloud"
                        ) -> float:
        busy = self.stage_busy(stage)
        cap = self._capacity(stage)
        return 1.0 - busy / cap if self.makespan > 0 else 0.0


def plan_from_stage_times(st: StageTimes, early_exit: bool = False,
                          bits_scale: float = 1.0,
                          exit_hop: Optional[int] = None) -> TaskPlan:
    """bits_scale rescales transmission time (online quant adjustment);
    ``exit_hop`` marks a hop-level semantic exit at that segment."""
    if early_exit or exit_hop == 0:
        return TaskPlan(st.T_e, 0.0, 0.0, True)
    if st.n_hops == 1:
        return TaskPlan(st.T_e, st.T_t * bits_scale, st.T_c,
                        tx_offset=min(st.first_tx_offset, st.T_e),
                        cloud_offset=st.cloud_start_offset)
    return TaskPlan.multihop(
        compute=st.compute,
        tx=tuple(t * bits_scale for t in st.link),
        tx_offsets=tuple(min(st.tx_offsets[k], st.compute[k])
                         for k in range(st.n_hops)),
        rx_offsets=st.rx_offsets, exit_hop=exit_hop)


def result_from_stream(res: sim.StreamResult) -> PipelineResult:
    """Wrap a raw resource timeline (from ``sim.simulate_stream`` or the
    async hop-queue executor) into the engine-facing result type."""
    recs = [TaskRecord(i, arr, d, d - arr, ee, eh)
            for i, (arr, d, ee, eh) in enumerate(zip(res.arrivals, res.done,
                                                     res.early_exit,
                                                     res.exit_hop))]
    return PipelineResult(recs, res.makespan, res.compute_busy,
                          res.link_busy,
                          compute_intervals=res.compute_intervals,
                          link_intervals=res.link_intervals)


def result_from_pool_stream(res: sim.PoolStreamResult) -> PipelineResult:
    """Wrap a replicated-tier timeline (``sim.simulate_pool_stream`` or
    the async pool executor) into the engine-facing result type.  The
    tier view merges each pool's replica intervals; ``pool_sizes`` keeps
    the replica counts so utilization is judged against
    ``m * makespan``."""
    pr = result_from_stream(res.as_stream_result())
    pr.pool_sizes = tuple(p.m for p in res.pools)
    return pr


def run_pipeline(plans: Sequence[TaskPlan],
                 arrivals: Optional[Sequence[float]] = None,
                 arrival_period: float = 0.0,
                 link: Optional[LinkProfile] = None,
                 links: Optional[Sequence[Optional[LinkProfile]]] = None,
                 batch_caps: Optional[Sequence[int]] = None,
                 pools: Optional[Sequence] = None,
                 router=None, sink=None, migrate=None) -> PipelineResult:
    """Execute the task stream.  ``link`` (classic) or ``links`` (one per
    hop) with a bandwidth trace re-integrates each task's transmission
    time at its actual start time (dynamic networks, Fig. 5).
    ``batch_caps`` enables per-tier continuous micro-batching (see
    ``sim.simulate_stream``).  ``pools`` (per-tier replica pools, see
    ``sim.PoolSpec``) with a ``router`` (``serving.routing`` policy,
    duck-typed here so the core stays serving-free) runs the replicated
    DAG path instead of the serial chain.  ``sink`` (a
    ``repro_torch.obs.trace`` span sink) records the timeline as spans; the
    async executor emits the same spans, so traces are differentially
    pinned like results.  ``migrate`` is the online re-planning hook of
    ``sim.simulate_stream`` (chain path only)."""
    n = len(plans)
    if arrivals is None:
        arrivals = [i * arrival_period for i in range(n)]
    if links is None:
        links = [link]
    # the deployment's links set the resource count floor: a stream of
    # early-exited (1-hop) plans on a 3-tier deployment still accounts
    # every tier's (idle) resources
    n_hops = max(max(p.n_hops for p in plans), len(links))
    sim_plans = [p.as_sim_plan(n_hops) for p in plans]
    if pools is not None:
        assert router is not None, "replicated tiers need a router policy"
        assert migrate is None, \
            "plan migration composes with the unbatched chain path only"
        pres = sim.simulate_pool_stream(sim_plans, arrivals, pools, router,
                                        links=links, batch_caps=batch_caps,
                                        sink=sink)
        return result_from_pool_stream(pres)
    res = sim.simulate_stream(sim_plans, arrivals, links=links,
                              batch_caps=batch_caps, sink=sink,
                              migrate=migrate)
    return result_from_stream(res)


def bandwidth_step_trace(steps: Sequence[tuple]) -> Callable[[float], float]:
    """[(t_from, mbps), ...] -> bps trace function."""
    steps = sorted(steps)

    def trace(t: float) -> float:
        bw = steps[0][1]
        for (t0, m) in steps:
            if t >= t0:
                bw = m
        return bw * 1e6

    return trace
