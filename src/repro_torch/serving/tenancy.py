"""Multi-tenant admission & fairness on the async hop-queue engine.

COACH's throughput story assumes a shared cloud tier serving many end
devices, but a single ``AsyncHopPipeline`` executes one task stream.
This module admits *several* per-tenant task streams through one shared
``2n+1`` resource chain:

  ``TenantSpec``            one tenant's workload contract: arrival
                            process, fairness weight, latency SLO.
  admission policies        pluggable schedulers deciding which tenant's
                            head task enters the shared chain next —
                            FIFO (global arrival order), round-robin,
                            and weighted deficit round-robin (WDRR).
  ``MultiTenantHopPipeline``  per-tenant admit workers (decisions happen
                            at each task's arrival instant) feeding one
                            policy dispatcher that is released by
                            *ingress credits*: the shared end worker
                            issues a credit exactly when it becomes
                            free, so admission is gated by the first
                            resource of the chain (and, with bounded
                            hop queues, by downstream backpressure).
  ``MultiTenantCoachEngine``  one COACH engine state per tenant (own
                            semantic cache, thresholds, per-hop
                            bandwidth EMAs) sharing the executor; co-
                            tenancy can never change a tenant's online
                            decisions, only its timing.

Differential contract (pinned by ``tests/test_tenancy.py``): with
unbounded queues and a ``VirtualClock``, the executor's admission order
and full resource timeline equal ``core.sim.simulate_multitenant_stream``
— which computes the same ingress gate arithmetically — to float
precision, for every admission policy.  The policy *state machines* are
shared between the two sides; the *gating semantics* (event-driven
credits vs. arithmetic ``free_0``) are implemented independently, which
is exactly what the harness pins.

Fairness-vs-bubble tradeoff: FIFO admits a bursty tenant's backlog ahead
of everyone — by work conservation it is minimax-optimal for *raw*
worst-tenant p99 (the burster's self-queueing floors that metric under
every policy), but it lets the burst blow tight-SLO tenants far outside
their targets.  WDRR interleaves per weight, so the *SLO-normalized*
worst tenant (``MultiTenantStats.worst_tenant_norm_p99``) and min SLO
attainment improve by large factors at near-identical bubble fractions
(``benchmarks/multitenant.py`` measures both sides).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import sim
from repro_torch.core.pipeline import (PipelineResult, TaskPlan, TaskRecord,
                                 result_from_pool_stream,
                                 result_from_stream)
from repro_torch.obs.trace import CREDIT_WAIT, ENQUEUE, Span
from repro_torch.serving.async_engine import (AsyncHopPipeline, HopQueue,
                                        VirtualClock, _Msg, _STOP)
from repro_torch.serving.base import EngineBase, EngineConfig, EngineStats

__all__ = ["TenantSpec", "AdmissionPolicy", "FifoAdmission",
           "RoundRobinAdmission", "WeightedDeficitRoundRobin",
           "ADMISSION_POLICIES", "make_policy", "task_count_cost",
           "service_time_cost", "MultiTenantHopPipeline",
           "run_multitenant_async", "tenant_pipeline_result",
           "TenantReport", "MultiTenantStats", "MultiTenantCoachEngine"]


# ==================================================================== specs
@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's workload contract.

    ``arrivals`` (explicit, non-decreasing) overrides the periodic
    process ``start + i * arrival_period``.  ``weight`` is the WDRR
    fairness share; ``slo_latency`` the per-task latency target used for
    SLO-attainment accounting (``None`` = no SLO)."""
    name: str
    n_tasks: int
    arrival_period: float = 0.0
    start: float = 0.0
    arrivals: Optional[Tuple[float, ...]] = None
    weight: float = 1.0
    slo_latency: Optional[float] = None

    def arrival_times(self) -> List[float]:
        if self.arrivals is not None:
            a = list(self.arrivals)
            assert len(a) == self.n_tasks, \
                f"tenant {self.name}: {len(a)} arrivals != {self.n_tasks}"
        else:
            a = [self.start + i * self.arrival_period
                 for i in range(self.n_tasks)]
        assert all(x0 <= x1 for x0, x1 in zip(a, a[1:])), \
            f"tenant {self.name}: arrivals must be non-decreasing"
        return a


# ================================================================= policies
def task_count_cost(plan: sim.SimPlan) -> float:
    """WDRR cost: every task costs one quantum unit (weighted fair task
    counts — robust when per-task service times are comparable)."""
    return 1.0


def service_time_cost(plan: sim.SimPlan) -> float:
    """WDRR cost: the task's total resource demand in seconds (heavier
    tasks consume proportionally more of their tenant's share).  A task
    exiting at segment ``e`` only demands compute ``0..e`` and links
    ``0..e-1``."""
    e = plan.exit_hop if plan.exit_hop is not None else len(plan.tx)
    return float(sum(plan.compute[:e + 1]) + sum(plan.tx[:e]))


class AdmissionPolicy:
    """Decides which candidate tenant's head task enters the shared
    chain next.

    The interface is shared by ``core.sim.multitenant_admission_order``
    (arithmetic ingress gate) and ``MultiTenantHopPipeline`` (event-
    driven ingress credits): ``reset(n_tenants)`` clears state, then
    ``pick(candidates, heads)`` is called once per admitted task with
    the tenants whose head task has arrived by the dispatch instant and
    ``heads[t] = (arrival, per-tenant index, SimPlan)``.  ``pick`` must
    return a candidate and be deterministic in its call sequence."""

    name = "abstract"

    def reset(self, n_tenants: int) -> None:
        self.n = n_tenants

    def pick(self, candidates: Sequence[int],
             heads: Dict[int, Tuple[float, int, sim.SimPlan]]) -> int:
        raise NotImplementedError


class FifoAdmission(AdmissionPolicy):
    """Global arrival order (ties break toward the lower tenant index):
    the single-queue baseline — a bursty tenant's backlog is served
    ahead of everything that arrived after it."""

    name = "fifo"

    def pick(self, candidates, heads):
        return min(candidates, key=lambda t: (heads[t][0], t))


class RoundRobinAdmission(AdmissionPolicy):
    """Cycle over tenants with a ready head task, one task per turn."""

    name = "rr"

    def reset(self, n_tenants):
        super().reset(n_tenants)
        self._last = n_tenants - 1

    def pick(self, candidates, heads):
        cset = set(candidates)
        for d in range(1, self.n + 1):
            t = (self._last + d) % self.n
            if t in cset:
                self._last = t
                return t
        raise AssertionError("no candidate tenant")


class WeightedDeficitRoundRobin(AdmissionPolicy):
    """Deficit round-robin (Shreedhar & Varghese) with per-tenant
    quanta proportional to ``weights``.

    Each visit to a tenant with a ready head tops up its deficit by
    ``weight * quantum`` once; the head is admitted while the deficit
    covers ``cost_fn(plan)`` (default: one unit per task, i.e. weighted
    fair task counts; ``service_time_cost`` charges seconds of resource
    demand instead).  A tenant with nothing ready forfeits its deficit —
    idle credit does not accumulate."""

    name = "wdrr"
    _EPS = 1e-12  # float slack for fractional-weight deficit sums

    def __init__(self, weights: Optional[Sequence[float]] = None,
                 quantum: float = 1.0,
                 cost_fn: Callable[[sim.SimPlan], float] = task_count_cost):
        self.weights = list(weights) if weights is not None else None
        self.quantum = quantum
        self.cost_fn = cost_fn

    def reset(self, n_tenants):
        super().reset(n_tenants)
        w = self.weights if self.weights is not None else [1.0] * n_tenants
        assert len(w) == n_tenants and all(x > 0 for x in w), \
            "need one positive weight per tenant"
        self._q = [x * self.quantum for x in w]
        self._deficit = [0.0] * n_tenants
        self._c = 0
        self._topped = False

    def pick(self, candidates, heads):
        cset = set(candidates)
        for t in range(self.n):
            if t not in cset:
                self._deficit[t] = 0.0
        while True:
            t = self._c
            if t in cset:
                cost = self.cost_fn(heads[t][2])
                if not self._topped:
                    self._deficit[t] += self._q[t]
                    self._topped = True
                if self._deficit[t] + self._EPS >= cost:
                    self._deficit[t] -= cost
                    return t
            self._c = (self._c + 1) % self.n
            self._topped = False


ADMISSION_POLICIES = {
    "fifo": FifoAdmission,
    "rr": RoundRobinAdmission,
    "wdrr": WeightedDeficitRoundRobin,
}


def make_policy(policy, weights: Optional[Sequence[float]] = None,
                **kwargs) -> AdmissionPolicy:
    """Resolve ``policy`` (name or instance) to a fresh policy object;
    ``weights``/``kwargs`` only apply to weighted policies."""
    if isinstance(policy, AdmissionPolicy):
        return policy
    cls = ADMISSION_POLICIES[policy]
    if cls is WeightedDeficitRoundRobin:
        return cls(weights=weights, **kwargs)
    return cls()


# ================================================================= executor
class MultiTenantHopPipeline:
    """Tagged multi-tenant admission over one shared ``AsyncHopPipeline``.

    One admit worker per tenant sleeps to each task's arrival and calls
    that tenant's ``plan_fn`` *at the arrival instant* (per-tenant
    decision order is therefore independent of co-tenants); a single
    dispatcher, released by ingress credits each time the shared end
    worker frees, picks the next tenant via the admission policy and
    forwards the head task into the chain.  See the module docstring for
    the differential contract with ``core.sim``."""

    def __init__(self, n_hops: int, links=None, clock=None,
                 queue_capacity: int = 0, segment_fn=None,
                 policy: AdmissionPolicy | str = "fifo",
                 weights: Optional[Sequence[float]] = None,
                 batch_caps: Optional[Sequence[int]] = None,
                 pools=None, router=None, sink=None, migrate=None):
        # tier 0 never batches under multi-tenancy: admission is credit-
        # gated one task at a time, so the ingress queue holds at most
        # one task and a tier-0 drain would diverge from the admission
        # gate (``sim.simulate_multitenant_stream`` applies the same
        # clamp to stay pinned).  With ``pools=`` the ingress credit
        # generalizes to *pool* ingress — every tier-0 replica issues a
        # credit when it frees, so up to ``m`` tasks are admitted into
        # the ingress pool at once (``sim.multitenant_pool_admission``
        # computes the same gate as a min-heap of completion instants)
        if batch_caps is not None:
            batch_caps = [1] + [int(c) for c in batch_caps[1:]]
        # the migration hook is keyed by the *global admission slot*
        # (``_Msg.idx``), the same index ``sim.simulate_multitenant_
        # stream`` replays the merged stream with
        self.pipe = AsyncHopPipeline(n_hops, links=links, clock=clock,
                                     queue_capacity=queue_capacity,
                                     segment_fn=segment_fn,
                                     batch_caps=batch_caps,
                                     pools=pools, router=router, sink=sink,
                                     migrate=migrate)
        self.policy = make_policy(policy, weights=weights)

    @property
    def outputs(self) -> dict:
        return self.pipe.outputs

    def run(self, plan_fns: Sequence[Callable[[int, float], Any]],
            arrivals_by_tenant: Sequence[Sequence[float]],
            payloads: Optional[Sequence[Sequence[Any]]] = None
            ) -> sim.MultiTenantStreamResult:
        """Admit every tenant's stream; ``plan_fns[t](i, t_arr)`` returns
        task ``i`` of tenant ``t``'s plan at its arrival."""
        clock = self.pipe.clock
        n_hops = self.pipe.n_hops
        n_t = len(plan_fns)
        arrivals_by_tenant = [list(a) for a in arrivals_by_tenant]
        assert len(arrivals_by_tenant) == n_t
        for a in arrivals_by_tenant:
            assert all(x0 <= x1 for x0, x1 in zip(a, a[1:])), \
                "per-tenant arrivals must be non-decreasing"
        total = sum(len(a) for a in arrivals_by_tenant)
        assert total > 0, "empty multi-tenant stream"
        policy = self.policy
        policy.reset(n_t)
        sink = self.pipe.sink
        ready: List[collections.deque] = [collections.deque()
                                          for _ in range(n_t)]
        served = [0] * n_t
        order: List[sim.TenantSlot] = []
        strict = isinstance(clock, VirtualClock)

        async def admit_fn(q0: HopQueue, credits: HopQueue, record):
            async def tenant_admit(t: int):
                for i, arr in enumerate(arrivals_by_tenant[t]):
                    await clock.sleep_until(arr)
                    plan = plan_fns[t](i, arr)
                    if isinstance(plan, TaskPlan):
                        plan = plan.as_sim_plan(n_hops)
                    assert len(plan.tx) == n_hops, \
                        "plan/deployment hop mismatch"
                    payload = payloads[t][i] if payloads is not None else None
                    ready[t].append((i, arr, plan, payload))

            async def dispatch():
                admitted = 0
                while admitted < total:
                    await credits.get()   # shared end worker became free
                    await clock.settle()
                    while True:
                        cands = [t for t in range(n_t) if ready[t]]
                        if cands:
                            break
                        future = [arrivals_by_tenant[t][served[t]]
                                  for t in range(n_t)
                                  if served[t] < len(arrivals_by_tenant[t])]
                        nxt = min(future)
                        if nxt <= clock.now:
                            if strict:
                                raise RuntimeError(
                                    "tenant admit worker failed to deposit "
                                    f"a task that arrived at {nxt}")
                            await clock.sleep(1e-4)  # wall clock: re-poll
                        else:
                            await clock.sleep_until(nxt)
                        await clock.settle()
                    heads = {t: (ready[t][0][1], ready[t][0][0],
                                 ready[t][0][2]) for t in cands}
                    t = policy.pick(cands, heads)
                    i, arr, plan, payload = ready[t].popleft()
                    served[t] += 1
                    idx = admitted
                    admitted += 1
                    order.append((t, i))
                    record(idx, arr)
                    if sink is not None:
                        # dispatch instant = the admission gate's t_d
                        # (``sim.multitenant_admission_order`` /
                        # ``multitenant_pool_admission`` compute the same
                        # instants arithmetically)
                        if clock.now > arr:
                            sink.span(Span(CREDIT_WAIT, ("compute", 0),
                                           arr, clock.now, task=idx))
                        sink.span(Span(ENQUEUE, ("compute", 0), clock.now,
                                       clock.now, task=idx))
                    await q0.put(_Msg(idx, plan, ready_at=arr, data_done=arr,
                                      payload=payload, tenant=t))
                await q0.put(_STOP)

            # children are clock-spawned workers; completion (and error
            # propagation) funnels through a clock-aware done queue so the
            # virtual driver's quiescence accounting stays exact
            done_q = HopQueue(clock)
            errs: List[BaseException] = []

            async def guarded(coro):
                try:
                    await coro
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errs.append(e)
                finally:
                    await done_q.put(None)

            for t in range(n_t):
                clock.spawn(guarded(tenant_admit(t)))
            clock.spawn(guarded(dispatch()))
            for _ in range(n_t + 1):
                await done_q.get()
            if errs:
                raise errs[0]

        res = self.pipe.run(None, total, None, admit_fn=admit_fn)
        if isinstance(res, sim.PoolStreamResult):
            return sim.MultiTenantPoolStreamResult(
                stream=res.as_stream_result(), order=tuple(order),
                n_tenants=n_t, pool=res)
        return sim.MultiTenantStreamResult(stream=res, order=tuple(order),
                                           n_tenants=n_t)


def run_multitenant_async(plans_by_tenant: Sequence[Sequence[TaskPlan]],
                          arrivals_by_tenant: Sequence[Sequence[float]],
                          policy: AdmissionPolicy | str = "fifo",
                          weights: Optional[Sequence[float]] = None,
                          links=None, queue_capacity: int = 0, clock=None,
                          segment_fn=None, payloads=None,
                          batch_caps: Optional[Sequence[int]] = None,
                          pools=None, router=None, sink=None, migrate=None
                          ) -> sim.MultiTenantStreamResult:
    """Async-executor counterpart of ``sim.simulate_multitenant_stream``
    (or, with ``pools=``, of ``sim.simulate_multitenant_pool_stream``):
    same plan normalization, same result type, but the merged stream is
    *executed* by per-resource workers behind a policy dispatcher.  With
    unbounded queues and a ``VirtualClock`` the two admission orders and
    timelines agree to float precision (including per-tier micro-batching
    via ``batch_caps``; tier 0 is clamped to cap 1 on both sides)."""
    if links is None:
        links = [None]
    n_hops = max(max(p.n_hops for ps in plans_by_tenant for p in ps),
                 len(links))
    sps = [[p.as_sim_plan(n_hops) for p in ps] for ps in plans_by_tenant]
    pipe = MultiTenantHopPipeline(n_hops, links=links, clock=clock,
                                  queue_capacity=queue_capacity,
                                  segment_fn=segment_fn, policy=policy,
                                  weights=weights, batch_caps=batch_caps,
                                  pools=pools, router=router, sink=sink,
                                  migrate=migrate)
    plan_fns = [(lambda t: lambda i, _arr: sps[t][i])(t)
                for t in range(len(sps))]
    return pipe.run(plan_fns, arrivals_by_tenant, payloads=payloads)


# ================================================================ reporting
def tenant_pipeline_result(mt: sim.MultiTenantStreamResult,
                           tenant: int) -> PipelineResult:
    """Slice one tenant's view out of a merged multi-tenant timeline:
    its task records plus its own occupation of every shared resource.
    ``makespan`` spans the tenant's own activity (first arrival to last
    completion), so per-tenant throughput is the tenant's service rate,
    not the global one."""
    s = mt.stream
    slots = mt.tenant_slots(tenant)
    arr, done, exits = mt.tenant_view(tenant)
    ehs = mt.tenant_exit_hops(tenant)
    recs = [TaskRecord(i, a, d, d - a, e, eh)
            for i, (a, d, e, eh) in enumerate(zip(arr, done, exits, ehs))]
    makespan = (max(done) - min(arr)) if done else 0.0
    n_seg = len(s.compute_busy)
    n_hops = len(s.link_busy)
    slotset = set(slots)
    comp_iv: List[List[sim.Interval]] = [[] for _ in range(n_seg)]
    link_iv: List[List[sim.Interval]] = [[] for _ in range(n_hops)]
    if s.compute_intervals:
        # a resource's interval list only contains the slots that occupy
        # it (a task exiting at segment e occupies compute 0..e and links
        # 0..e-1): map each tenant slot to its position in that per-
        # resource ordering.  Under micro-batching one compute interval
        # serves a consecutive run of occupying slots
        # (``compute_batch_sizes``); a shared batch interval is
        # attributed to *every* tenant with a member in it, so
        # per-tenant busy time counts a shared launch in full (links
        # never batch and stay 1:1)
        def _slice(intervals, occupies, sizes=None):
            occ = [j for j in range(len(mt.order))
                   if occupies(s.exit_hop[j])]
            if not sizes:
                sizes = [1] * len(intervals)
            out = []
            pos = 0
            for iv, n_b in zip(intervals, sizes):
                if any(j in slotset for j in occ[pos:pos + n_b]):
                    out.append(iv)
                pos += n_b
            return out

        for k in range(n_seg):
            comp_iv[k] = _slice(
                s.compute_intervals[k],
                lambda eh, k=k: sim.occupies_compute(eh, k),
                s.compute_batch_sizes[k]
                if s.compute_batch_sizes else None)
        for k in range(n_hops):
            link_iv[k] = _slice(s.link_intervals[k],
                                lambda eh, k=k: sim.occupies_link(eh, k))
    return PipelineResult(
        recs, makespan,
        compute_busy=tuple(sum(e - st for (st, e) in iv) for iv in comp_iv),
        link_busy_hops=tuple(sum(e - st for (st, e) in iv)
                             for iv in link_iv),
        compute_intervals=tuple(tuple(iv) for iv in comp_iv),
        link_intervals=tuple(tuple(iv) for iv in link_iv))


@dataclasses.dataclass
class TenantReport:
    """One tenant's outcome under contention."""
    spec: TenantSpec
    stats: EngineStats            # decisions + tenant-sliced pipeline
    slo_attainment: Optional[float]  # P(latency <= slo); None without SLO


@dataclasses.dataclass
class MultiTenantStats:
    """Outcome of one multi-tenant engine run."""
    pipeline: PipelineResult                  # merged shared-chain view
    order: Tuple[sim.TenantSlot, ...]         # admission sequence
    reports: List[TenantReport]
    policy: str
    plans: List[List[sim.SimPlan]]            # per-tenant decided plans
    arrivals: List[List[float]]               # per-tenant arrival times

    @property
    def worst_tenant_p99(self) -> float:
        """Raw worst per-tenant p99.  Note: for open arrivals through one
        work-conserving chain, FIFO essentially *minimizes* this (it is
        minimax-optimal for waiting time; a bursty tenant's self-queueing
        floors the metric under every policy), so fair policies tie or
        slightly exceed it — the fairness win lives in the SLO-normalized
        view below."""
        return max(r.stats.pipeline.p99_latency for r in self.reports)

    @property
    def worst_tenant_norm_p99(self) -> Optional[float]:
        """Worst SLO-normalized p99, ``max_t p99_t / slo_t`` — the
        multi-tenant fairness headline: heterogeneous-SLO tenants are
        only comparable after normalizing, and weighted-DRR keeps every
        tenant's p99 inside (or near) its own SLO while FIFO lets a
        bursty tenant blow the tight-SLO tenants far out of theirs.
        ``None`` when no tenant declares an SLO."""
        vals = [r.stats.pipeline.p99_latency / r.spec.slo_latency
                for r in self.reports if r.spec.slo_latency]
        return max(vals) if vals else None

    @property
    def min_slo_attainment(self) -> Optional[float]:
        vals = [r.slo_attainment for r in self.reports
                if r.slo_attainment is not None]
        return min(vals) if vals else None


# =================================================================== engine
class MultiTenantCoachEngine:
    """COACH serving engine for several tenants sharing one hop chain.

    Each tenant owns a full online state — semantic cache, calibrated
    thresholds, ``OnlineScheduler`` with its own uplink/per-hop bandwidth
    EMAs — built by a private ``EngineBase``; decisions happen at each
    task's arrival instant inside that tenant's admit worker, so a
    tenant's decision sequence is identical to what it would make running
    alone (co-tenancy changes timing, never decisions).  The admission
    policy then interleaves the decided plans into the shared
    ``MultiTenantHopPipeline``."""

    def __init__(self, runtime, stage_times, end_dev, link, cloud_dev,
                 n_labels: int, calib_feats: np.ndarray,
                 calib_labels: np.ndarray, tenants: Sequence[TenantSpec],
                 policy: AdmissionPolicy | str = "fifo",
                 cfg: Optional[EngineConfig] = None,
                 boundary_elems: Optional[int] = None,
                 links=None, hop_bits_offline=None, hop_calib=None):
        assert tenants, "need at least one tenant"
        self.tenants = list(tenants)
        self.cfg = cfg if cfg is not None else EngineConfig()
        if self.cfg.auto_batch and self.cfg.batch_slack is None:
            # derive the batch-size finder's staleness budget from the
            # tightest tenant SLO: the slack left after a single task's
            # unloaded latency is what batching may consume
            slos = [t.slo_latency for t in self.tenants
                    if t.slo_latency is not None]
            assert slos, "auto_batch needs batch_slack or a tenant SLO"
            self.cfg = dataclasses.replace(
                self.cfg,
                batch_slack=max(0.0, min(slos) - stage_times.latency))
        # one private engine state per tenant (fresh config copy each, so
        # a tenant-level config edit can never leak across tenants; each
        # tenant also calibrates its own hop probes from hop_calib, so
        # hop-level exit decisions stay tenant-isolated).  Credit-gated
        # admission holds the ingress queue at depth <= 1, so tier 0 can
        # never batch: pin ingress_cap = 1 so the auto batch-size finder
        # redistributes tier 0's slack share to tiers that can use it.
        # trace/metrics stay on the *shared* config only: the trace is a
        # whole-chain timeline, so per-tenant _stats must not re-populate
        # the registry once per tenant (run_streams fills it once).
        self.engines: List[EngineBase] = [
            EngineBase(runtime, stage_times, end_dev, link, cloud_dev,
                       n_labels, calib_feats, calib_labels,
                       cfg=dataclasses.replace(self.cfg, ingress_cap=1,
                                               trace=None, metrics=None),
                       boundary_elems=boundary_elems, links=links,
                       hop_bits_offline=hop_bits_offline,
                       hop_calib=hop_calib)
            for _ in self.tenants]
        self.links = self.engines[0].links
        # caps are config-derived, so every per-tenant engine agrees;
        # the pipeline clamps tier 0 to cap 1 (credit-gated ingress)
        self.batch_caps = self.engines[0].batch_caps
        # replicated tiers: one shared pool topology for the chain (the
        # tenants share the replicas; the router may still pin a tenant
        # to a replica via the "affinity" policy)
        self.pools = self.engines[0].pools
        self.policy = make_policy(policy,
                                  weights=[t.weight for t in self.tenants])

    def run_streams(self, tasks_by_tenant, classify, clock=None
                    ) -> MultiTenantStats:
        """Serve every tenant's task list through the shared chain.

        ``classify(task) -> (features, predicted_label)`` as in the
        single-stream engines.  Returns merged + per-tenant stats; the
        decided per-tenant ``SimPlan``s and arrivals are included so a
        differential harness can replay the exact run through
        ``core.sim.simulate_multitenant_stream``."""
        n_t = len(self.tenants)
        assert len(tasks_by_tenant) == n_t
        tasks_by_tenant = [list(ts) for ts in tasks_by_tenant]
        for spec, ts in zip(self.tenants, tasks_by_tenant):
            assert len(ts) == spec.n_tasks, \
                f"tenant {spec.name}: {len(ts)} tasks != spec {spec.n_tasks}"
        arrivals = [spec.arrival_times() for spec in self.tenants]
        n_hops = len(self.links)
        accs = [{"exits": 0, "wire": 0.0, "bits": [], "correct": [],
                 "plans": []} for _ in range(n_t)]

        batching = self.batch_caps is not None \
            and any(c > 1 for c in self.batch_caps)

        def tenant_plan_fn(t: int):
            eng, acc, tasks = self.engines[t], accs[t], tasks_by_tenant[t]
            spec = self.tenants[t]

            def plan_fn(i: int, t_arr: float) -> sim.SimPlan:
                # same shared decision/accounting path as the single-
                # stream engines; only the bandwidth timestamp (this
                # task's arrival) is tenant-specific
                task = tasks[i]
                bw = eng.link.bps_at(t_arr)
                plan = eng.admit_plan(task, bw, t_arr, classify, acc)
                sp = plan.as_sim_plan(n_hops)
                if batching and sp.deadline is None \
                        and spec.slo_latency is not None:
                    # per-tenant staleness deadline from the SLO: batch
                    # formation never holds this task past its target
                    sp.deadline = t_arr + spec.slo_latency
                acc["plans"].append(sp)
                return sp

            return plan_fn

        pipe = MultiTenantHopPipeline(
            n_hops, links=self.links, clock=clock,
            queue_capacity=self.cfg.queue_capacity, policy=self.policy,
            batch_caps=self.batch_caps, pools=self.pools,
            router=self.engines[0].make_router(), sink=self.cfg.trace)
        mt = pipe.run([tenant_plan_fn(t) for t in range(n_t)], arrivals)

        reports = []
        for t, spec in enumerate(self.tenants):
            acc = accs[t]
            pr = tenant_pipeline_result(mt, t)
            stats = self.engines[t]._stats(
                pr, spec.n_tasks, acc["exits"], acc["bits"], acc["wire"],
                acc["correct"])
            slo = None
            if spec.slo_latency is not None:
                slo = float(np.mean([rec.latency <= spec.slo_latency
                                     for rec in pr.tasks]))
            reports.append(TenantReport(spec=spec, stats=stats,
                                        slo_attainment=slo))
        if isinstance(mt, sim.MultiTenantPoolStreamResult) \
                and mt.pool is not None:
            merged = result_from_pool_stream(mt.pool)
        else:
            merged = result_from_stream(mt.stream)
        if self.cfg.metrics is not None:
            # once, from the merged chain view (the per-tenant engines
            # run with metrics=None — see __init__)
            from repro_torch.obs.bubbles import attribute, chain_resources
            from repro_torch.obs.metrics import (populate_from_attribution,
                                           populate_from_result,
                                           populate_from_trace)
            reg = self.cfg.metrics
            populate_from_result(reg, merged)
            trace = self.cfg.trace
            if trace is not None and len(getattr(trace, "spans", ())) > 0:
                populate_from_trace(reg, trace)
                populate_from_attribution(reg, attribute(
                    trace, resources=chain_resources(
                        merged.n_hops, merged.pool_sizes or None)))
        return MultiTenantStats(
            pipeline=merged, order=mt.order,
            reports=reports, policy=self.policy.name,
            plans=[accs[t]["plans"] for t in range(n_t)],
            arrivals=arrivals)
