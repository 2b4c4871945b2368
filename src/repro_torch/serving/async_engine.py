"""Async hop-queue serving engine: real per-resource workers, pinned to
``core/sim``.

``core.sim.simulate_stream`` models a collaborative deployment as
``2n+1`` alternating serial FIFO resources.  This module *executes* that
model instead of replaying it: one asyncio worker per resource, chained
by bounded ``HopQueue``s, so segment ``k`` of task ``i`` genuinely runs
concurrently with segment ``k-1`` of task ``i+1`` and every hop's
transmission is an awaitable priced by its ``LinkProfile``.

Resource-worker <-> ``core/sim`` correspondence (the invariant the
differential test ``tests/test_async_engine.py`` pins):

  =====================  ==========================================
  ``simulate_stream``    ``AsyncHopPipeline``
  =====================  ==========================================
  ``compute_free[k]``    compute worker ``k``'s position in virtual
                         time (a serial worker is "free" exactly when
                         its loop returns to ``HopQueue.get``)
  ``link_free[k]``       link worker ``k``'s position in virtual time
  task admission order   FIFO order of the queue chain (each worker
                         processes and forwards in order)
  ``tx_ready``           ``_Msg.ready_at`` of the message the compute
                         worker forwards to its link queue (``prev_done``
                         for a serial plan, ``prev_start + tx_offset``
                         for an overlapped one)
  ``c_ready``            ``_Msg.ready_at`` the link worker stamps for
                         the downstream compute worker
                         (``t_done``, or ``t_start + rx_offset``)
  ``c_done = max(...)``  the downstream worker sleeps its compute time,
                         then ``sleep_until(data_done)`` — it cannot
                         finish before all data has arrived
  trace re-integration   the link worker reprices the planned bit
                         volume with ``LinkProfile.transfer_time`` at
                         the transfer's actual virtual start
  boundary quantize +    the fused single-pass boundary kernel
  semantic probe         (``kernels.boundary`` via ``CollabRuntime.
  (priced inside         segment_handle(probe_centers=)``): worker
  ``compute[k]``)        ``k``'s segment forward emits the hop-``k``
                         wire packet *and* the ``BoundaryProbe`` in one
                         HBM read of the activation; the lifted
                         ``ProbeResult`` feeds the enqueue-time
                         decision in place of the scheduler's recompute
  =====================  ==========================================

With ``pools=`` the chain generalizes to *replicated tiers*
(``core.sim.simulate_pool_stream``; pinned by ``tests/test_pools.py``):

  ==========================  =====================================
  ``simulate_pool_stream``    ``AsyncHopPipeline(pools=...)``
  ==========================  =====================================
  dispatch (router placing    one *dispatcher* worker per tier: gets
  each pending task, in       from the pool input queue, calls
  admission order)            ``router.route`` per task in seq order,
                              forwards to the chosen replica's queue
  replica replay (per-        one worker per replica: the chain
  replica FIFO + batching,    compute worker with its service times
  ``speed * compute[k]``)     scaled by ``PoolSpec.speeds[r]``
  sequencer (running max of   one *sequencer* worker per hop: buffers
  release instants restores   ``(seq, msg)`` releases and forwards to
  admission order)            the serial link strictly in seq order
  pool ingress credits        every tier-0 replica puts one credit
  (min-heap of completion     before each ``get`` — a token the
  instants, ``m`` zeros)      moment *any* ingress replica frees
  ==========================  =====================================

Router state is strictly per tier and never reads the clock, so the
executor's wall-time interleaving of tiers reaches the same placements
as the simulator's tier-by-tier staged replay (see
``repro_torch.serving.routing``).

Timing comes from a pluggable clock: ``VirtualClock`` is a deterministic
discrete-event driver (timers fire only when every worker is blocked, so
a run is a bit-reproducible event simulation — this is what makes the
executor directly comparable to ``simulate_stream``); ``WallClock`` maps
the same awaits onto real ``asyncio.sleep``.  With unbounded queues the
virtual-clock timeline reproduces ``simulate_stream`` exactly; bounded
queues add admission/backpressure (an upstream worker stalls on ``put``
when its hop queue is full), which the pure simulator does not model.

``AsyncCoachEngine`` rides the online component on top: ``OnlineScheduler``
decisions (early exit Eq. 10, adaptive precision Eq. 11) are made at
enqueue time on the end worker, in task order — concurrency never changes
*decisions*, only timing — and per-hop adaptive bits pick a precision per
``WirePacket`` hop from per-hop bandwidth EMAs
(``OnlineScheduler.choose_hop_bits``).  ``classify`` may return a
3-tuple ``(features, pred, probes)`` carrying the fused boundary pass's
precomputed ``ProbeResult``(s); the cascade consumes them directly
(``EngineBase.decide``), so no engine re-reads the boundary activation.

Multi-tenant admission lives one layer up in ``repro_torch.serving.tenancy``:
``AsyncHopPipeline.run`` accepts a pluggable admitter (``admit_fn``)
which is released by *ingress credits* — a token issued each time the
end worker is about to block on its input queue — so a policy scheduler
can gate per-tenant streams on the shared ingress resource.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import heapq
import itertools
from typing import Any, Callable, List, Optional, Sequence, Tuple

from repro_torch.core import sim
from repro_torch.core.costs import LinkProfile
from repro_torch.core.pipeline import (PipelineResult, TaskPlan,
                                 result_from_stream)
from repro_torch.obs.trace import (BATCH_FORM, ENQUEUE, EXIT_RELEASE, REPLAN,
                             ROUTE, SEQ_HOLD, SERVICE, XFER)
from repro_torch.serving.base import EngineBase, EngineStats

__all__ = ["VirtualClock", "WallClock", "HopQueue", "AsyncHopPipeline",
           "run_pipeline_async", "AsyncCoachEngine"]


# ==================================================================== clocks
class VirtualClock:
    """Deterministic virtual-time driver for a set of asyncio workers.

    Every blocking point of the executor (timed sleeps, queue gets/puts)
    registers with the clock.  A driver coroutine fires the earliest
    pending timer only when *all* registered workers are blocked, so the
    run is a discrete-event simulation: virtual time jumps from event to
    event and the interleaving is reproducible.
    """

    def __init__(self):
        self.now = 0.0
        # (when, seq, future, is_settle_sentinel); ordered by (when, seq)
        self._timers: List[Tuple[float, int, asyncio.Future, bool]] = []
        self._seq = itertools.count()
        self._blocked = 0   # workers suspended in a clock primitive
        self._live = 0      # workers spawned and not yet finished
        self._idle: Optional[asyncio.Event] = None

    # ---- bookkeeping shared with HopQueue
    def _maybe_idle(self):
        if self._idle is not None and self._blocked >= self._live:
            self._idle.set()

    async def _wait(self, fut: asyncio.Future):
        """Suspend the calling worker until ``_wake(fut)``."""
        self._blocked += 1
        self._maybe_idle()
        return await fut

    def _wake(self, fut: asyncio.Future, value: Any = None):
        self._blocked -= 1
        if not fut.done():
            fut.set_result(value)

    # ---- public interface
    async def sleep(self, dt: float):
        await self.sleep_until(self.now + dt)

    async def sleep_until(self, when: float):
        if when <= self.now:
            return
        fut = asyncio.get_event_loop().create_future()
        heapq.heappush(self._timers, (when, next(self._seq), fut, False))
        await self._wait(fut)

    async def settle(self):
        """Suspend until every event scheduled for the *current* virtual
        instant has fired.  A worker woken by a direct queue handoff may
        run while timers for the same instant are still pending in the
        heap; a sentinel timer pushed at ``now`` sorts after them (same
        ``when``, later seq), so awaiting it yields until the instant
        has fully played out.  Admission dispatchers use this before
        sampling queue state (``repro_torch.serving.tenancy``), batching
        compute workers before snapshotting their hop queue.

        Only *real* timers count: another worker's settle sentinel is
        not pending work, and honouring it would livelock two settles
        at the same instant (each re-arming against the other's
        sentinel forever)."""
        while any(when <= self.now and not sentinel
                  for (when, _, _, sentinel) in self._timers):
            fut = asyncio.get_event_loop().create_future()
            heapq.heappush(self._timers,
                           (self.now, next(self._seq), fut, True))
            await self._wait(fut)

    def spawn(self, coro) -> "asyncio.Task":
        """Register + start a worker; only spawned workers count toward
        the quiescence check that gates timer firing."""
        self._live += 1

        async def wrapped():
            try:
                return await coro
            finally:
                self._live -= 1
                self._maybe_idle()

        return asyncio.ensure_future(wrapped())

    async def _drive(self):
        while True:
            await self._idle.wait()
            self._idle.clear()
            if self._live == 0:
                return
            if not self._timers:
                raise RuntimeError(
                    "virtual-clock deadlock: all workers blocked with no "
                    "pending timer")
            when, _, fut, _sentinel = heapq.heappop(self._timers)
            self.now = max(self.now, when)
            self._wake(fut)

    def run(self, main):
        """Run ``main`` (which spawns workers via ``spawn``) to completion
        under virtual time; returns its result."""
        return asyncio.run(self._run(main))

    async def _run(self, main):
        self._idle = asyncio.Event()
        driver = asyncio.ensure_future(self._drive())
        main_t = asyncio.ensure_future(main)
        try:
            await asyncio.wait({driver, main_t},
                               return_when=asyncio.FIRST_COMPLETED)
            if driver.done() and driver.exception() is not None:
                main_t.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await main_t
                raise driver.exception()
            return await main_t
        finally:
            if not driver.done():
                driver.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await driver


class WallClock:
    """Real-time realization of the same clock interface: sleeps map to
    ``asyncio.sleep`` and ``now`` is the loop clock relative to the start
    of the run (best effort — scheduling jitter is real here)."""

    def __init__(self):
        self._t0: Optional[float] = None

    @property
    def now(self) -> float:
        loop = asyncio.get_event_loop()
        if self._t0 is None:
            self._t0 = loop.time()
        return loop.time() - self._t0

    async def sleep(self, dt: float):
        if dt > 0:
            await asyncio.sleep(dt)

    async def sleep_until(self, when: float):
        await self.sleep(when - self.now)

    async def settle(self):
        """Best-effort wall-clock counterpart of ``VirtualClock.settle``:
        yield to the scheduler a few times so same-instant callbacks run."""
        for _ in range(4):
            await asyncio.sleep(0)

    async def _wait(self, fut: asyncio.Future):
        return await fut

    def _wake(self, fut: asyncio.Future, value: Any = None):
        if not fut.done():
            fut.set_result(value)

    def spawn(self, coro) -> "asyncio.Task":
        return asyncio.ensure_future(coro)

    def run(self, main):
        return asyncio.run(main)


# ==================================================================== queue
class HopQueue:
    """Bounded FIFO channel between two pipeline resources.

    Like ``asyncio.Queue`` but clock-aware: a worker blocked in ``get``
    (empty) or ``put`` (full) is registered with the clock so the virtual
    driver knows the pipeline is quiescent.  ``maxsize = 0`` means
    unbounded (the waiting room of ``core/sim``'s serial resources)."""

    def __init__(self, clock, maxsize: int = 0):
        self._clock = clock
        self._max = maxsize
        self._items = collections.deque()
        self._getters = collections.deque()
        self._putters = collections.deque()  # (future, item)

    def __len__(self):
        return len(self._items)

    async def put(self, item):
        if self._getters:                       # direct handoff
            self._clock._wake(self._getters.popleft(), item)
            return
        if self._max and len(self._items) >= self._max:
            fut = asyncio.get_event_loop().create_future()
            self._putters.append((fut, item))
            await self._clock._wait(fut)        # backpressure: stall upstream
            return
        self._items.append(item)

    def _admit_putter(self):
        if self._putters:                       # a slot freed up
            fut, pitem = self._putters.popleft()
            self._items.append(pitem)
            self._clock._wake(fut)

    async def get(self):
        if self._items:
            item = self._items.popleft()
            self._admit_putter()
            return item
        fut = asyncio.get_event_loop().create_future()
        self._getters.append(fut)
        return await self._clock._wait(fut)

    def get_nowait(self):
        """Pop the head item without blocking; raises
        ``asyncio.QueueEmpty`` when nothing is queued."""
        if not self._items:
            raise asyncio.QueueEmpty
        item = self._items.popleft()
        self._admit_putter()
        return item

    def drain(self, n: int) -> list:
        """Pop up to ``n`` items (FIFO), admitting one blocked putter per
        freed slot.  Never blocks; returns what was there.

        A batching worker must decide *membership* from ``snapshot()``
        taken at its wake instant, then ``drain`` exactly that many: the
        naive pattern of sizing the drain from ``len(queue)`` at drain
        time races with same-timeline producers — a worker that slept
        between waking and draining would observe items enqueued *after*
        its wake instant, diverging from the simulator's arithmetic rule
        (which gathers the queue state at the wake instant only)."""
        out = []
        while len(out) < n and self._items:
            out.append(self._items.popleft())
            self._admit_putter()
        return out

    def snapshot(self) -> tuple:
        """The queued items at this instant, in FIFO order, not removed.
        Take this at the wake instant (after ``clock.settle()`` so every
        same-instant put has landed) to fix a batch's candidate set."""
        return tuple(self._items)


# ================================================================= executor
@dataclasses.dataclass
class _Msg:
    """One task's in-flight state between two adjacent resources."""
    idx: int
    plan: sim.SimPlan
    ready_at: float     # earliest time the receiving resource may start it
    data_done: float    # when the upstream transfer fully lands (c_done gate)
    payload: Any = None
    tenant: Optional[int] = None   # tag for tenant-affinity routing
    seq: int = 0                   # per-tier dispatch order (pool sequencer)


_STOP = object()


class AsyncHopPipeline:
    """``2n+1`` resource workers chained by hop queues (see module doc).

    ``segment_fn(k, idx, payload) -> payload`` optionally runs real
    compute (e.g. ``CollabRuntime.segment_handle(k)``) on each compute
    worker; the last segment's outputs are collected in ``outputs``.
    """

    def __init__(self, n_hops: int,
                 links: Optional[Sequence[Optional[LinkProfile]]] = None,
                 clock=None, queue_capacity: int = 0,
                 segment_fn: Optional[Callable[[int, int, Any], Any]] = None,
                 batch_caps: Optional[Sequence[int]] = None,
                 pools=None, router=None, sink=None, migrate=None):
        assert n_hops >= 1
        self.n_hops = n_hops
        self.n_seg = n_hops + 1
        self.links = list(links) if links is not None else [None] * n_hops
        self.clock = clock if clock is not None else VirtualClock()
        self.capacity = queue_capacity
        self.segment_fn = segment_fn
        # per-tier continuous micro-batching caps (None / 1 = unbatched);
        # missing trailing tiers default to 1
        self.batch_caps = [1] * self.n_seg
        if batch_caps is not None:
            for k, c in enumerate(batch_caps[:self.n_seg]):
                assert int(c) >= 1, "batch caps must be >= 1"
                self.batch_caps[k] = int(c)
        # replicated tiers: per-tier PoolSpec + a router policy object
        # (repro_torch.serving.routing); None = the classic 2n+1 chain
        self.pools = sim.as_pools(pools, self.n_seg) \
            if pools is not None else None
        if self.pools is not None:
            assert router is not None, "pool execution needs a router policy"
        self.router = router
        # span sink (``repro_torch.obs.trace``): every worker emits the same
        # spans, at the same virtual instants, as the simulator's staged
        # replay — the differential pin extends to traces.  ``None``
        # (default) emits nothing and allocates nothing.
        self.sink = sink
        # online re-planning hook ``migrate(idx, k, tx_ready)`` (see
        # ``sim.simulate_stream``): consulted by each link worker at its
        # task's boundary-ready instant, so both engines evaluate it
        # with identical arguments and reach identical plan switches.
        self.migrate = migrate
        if migrate is not None:
            assert self.pools is None and all(
                c <= 1 for c in self.batch_caps), \
                "plan migration composes with the unbatched chain path only"
        self.outputs: dict = {}

    def run(self, plan_fn: Callable[[int, float], Any], n_tasks: int,
            arrivals: Optional[Sequence[float]],
            payloads: Optional[Sequence[Any]] = None,
            admit_fn: Optional[Callable] = None) -> sim.StreamResult:
        """Admit ``n_tasks`` tasks at ``arrivals`` and execute the chain.

        ``plan_fn(i, t_arr)`` is called *at enqueue time* (in task order,
        at the task's virtual arrival) and returns the task's
        ``sim.SimPlan`` (or a ``TaskPlan``, normalized here) — this is
        the hook where online decisions happen.

        ``admit_fn(q0, credits, record)`` replaces the built-in
        single-stream admission worker (multi-tenant admission lives in
        ``repro_torch.serving.tenancy``).  It must put exactly ``n_tasks``
        ``_Msg``s with distinct ``idx`` in ``[0, n_tasks)`` into ``q0``
        followed by ``_STOP``, and call ``record(idx, arrival)`` for
        each.  ``credits`` is a clock-aware queue receiving one token
        every time the ingress compute worker (resource 0) is about to
        block on its input queue — i.e. exactly when it becomes free —
        so a policy admitter can gate dispatch on the shared ingress
        resource (and, through bounded hop queues, on downstream
        backpressure).  With ``admit_fn`` set, ``plan_fn``/``arrivals``/
        ``payloads`` are ignored.

        With ``pools=`` configured the run executes the replicated-tier
        topology instead and returns a ``sim.PoolStreamResult`` (per-
        replica timelines + routes); ``credits`` then receives one token
        whenever *any* tier-0 replica is about to block on its queue."""
        if self.pools is not None:
            return self._run_pool(plan_fn, n_tasks, arrivals, payloads,
                                  admit_fn)
        assert n_tasks > 0
        assert admit_fn is not None or (arrivals is not None
                                        and len(arrivals) >= n_tasks)
        clock = self.clock
        n_hops, n_seg = self.n_hops, self.n_seg
        comp_busy = [0.0] * n_seg
        link_busy = [0.0] * n_hops
        comp_iv: List[List[sim.Interval]] = [[] for _ in range(n_seg)]
        comp_bs: List[List[int]] = [[] for _ in range(n_seg)]
        link_iv: List[List[sim.Interval]] = [[] for _ in range(n_hops)]
        done = [0.0] * n_tasks
        exit_hops: List[Optional[int]] = [None] * n_tasks
        arrs = [0.0] * n_tasks if admit_fn is not None \
            else list(arrivals[:n_tasks])
        self.outputs = {}
        credits = HopQueue(clock) if admit_fn is not None else None
        sink = self.sink

        def record(idx: int, arrival: float):
            arrs[idx] = arrival

        async def admit(q0: HopQueue):
            emit = sink.span if sink is not None else None
            res0 = ("compute", 0)
            for i in range(n_tasks):
                arr = arrivals[i]
                await clock.sleep_until(arr)
                plan = plan_fn(i, arr)
                if isinstance(plan, TaskPlan):
                    plan = plan.as_sim_plan(n_hops)
                assert len(plan.tx) == n_hops, "plan/deployment hop mismatch"
                payload = payloads[i] if payloads is not None else None
                if emit is not None:
                    # put instant = running max of arrivals (serial admitter)
                    t = clock.now
                    emit((ENQUEUE, res0, t, t, i))
                await q0.put(_Msg(i, plan, ready_at=arr, data_done=arr,
                                  payload=payload))
            await q0.put(_STOP)

        async def compute_worker(k: int, qin: HopQueue,
                                 qout: Optional[HopQueue]):
            # span emission is on the hot path: prefix tuples + a bound
            # sink method, not Span(...) construction (see TraceRecorder)
            emit = sink.span if sink is not None else None
            res = ("compute", k, 0)
            cap = self.batch_caps[k]
            while True:
                if k == 0 and credits is not None:
                    await credits.put(None)
                msg = await qin.get()
                if msg is _STOP:
                    if qout is not None:
                        await qout.put(_STOP)
                    return
                if cap > 1:
                    # -------- continuous micro-batching (greedy drain) --
                    # membership is fixed against the queue state at the
                    # *wake* instant: settle() lets every same-instant
                    # put land, then snapshot() freezes the candidate
                    # set before we sleep toward the head's ready time
                    # (draining by len() after that sleep would admit
                    # later arrivals the simulator never sees)
                    await clock.settle()
                    cand = [msg]
                    for m in qin.snapshot():
                        if m is _STOP:
                            break
                        cand.append(m)
                    await clock.sleep_until(msg.ready_at)
                    s = clock.now             # = max(ready, wake)
                    n_b = sim.greedy_batch_size(
                        k, cap, s, [m.plan for m in cand],
                        [m.ready_at for m in cand])
                    if n_b > 1:
                        batch = [msg] + qin.drain(n_b - 1)
                        dur = sim.batched_service_time(
                            [m.plan for m in batch], k)
                        if self.segment_fn is not None:
                            for m in batch:
                                m.payload = self.segment_fn(
                                    k, m.idx, m.payload)
                        comp_busy[k] += dur
                        comp_iv[k].append((s, s + dur))
                        comp_bs[k].append(len(batch))
                        if emit is not None:
                            emit((SERVICE, res, s, s + dur, msg.idx,
                                  tuple(m.idx for m in batch),
                                  msg.ready_at, len(batch)))
                            for m in batch[1:]:
                                if s > m.ready_at:
                                    emit((BATCH_FORM, res, m.ready_at, s,
                                          m.idx))
                        await clock.sleep(dur)
                        # scatter completions in FIFO order; each member
                        # still gates on its own upstream data-done, and
                        # exit-hop members leave the batch at this tier
                        for m in batch:
                            await clock.sleep_until(m.data_done)
                            p = m.plan
                            if k == n_hops or (p.exit_hop is not None
                                               and k >= p.exit_hop):
                                done[m.idx] = clock.now
                                exit_hops[m.idx] = p.exit_hop
                                self.outputs[m.idx] = m.payload
                                if emit is not None \
                                        and p.exit_hop is not None:
                                    t = clock.now
                                    emit((EXIT_RELEASE, res, t, t, m.idx,
                                          None, None, None, p.exit_hop))
                            else:
                                await qout.put(_Msg(
                                    m.idx, p, ready_at=clock.now,
                                    data_done=clock.now,
                                    payload=m.payload))
                        continue
                await clock.sleep_until(msg.ready_at)
                start = clock.now                 # = max(ready, worker free)
                p = msg.plan
                comp = p.compute[k]
                if self.segment_fn is not None:
                    msg.payload = self.segment_fn(k, msg.idx, msg.payload)
                comp_busy[k] += comp
                comp_iv[k].append((start, start + comp))
                comp_bs[k].append(1)
                if emit is not None:
                    emit((SERVICE, res, start, start + comp, msg.idx,
                          (msg.idx,), msg.ready_at, 1))
                data_done = msg.data_done
                # a hop-level semantic exit at segment ``exit_hop``
                # terminates the task on this worker: nothing is ever
                # forwarded, so every downstream resource is released
                last = k == n_hops or \
                    (p.exit_hop is not None and k >= p.exit_hop)
                off = None if last else p.tx_offset[k]
                if last or off is None or off >= comp:   # serial stage
                    await clock.sleep(comp)
                    await clock.sleep_until(data_done)   # c_done gate
                    if last:
                        done[msg.idx] = clock.now
                        exit_hops[msg.idx] = p.exit_hop
                        self.outputs[msg.idx] = msg.payload
                        if emit is not None and p.exit_hop is not None:
                            t = clock.now
                            emit((EXIT_RELEASE, res, t, t, msg.idx,
                                  None, None, None, p.exit_hop))
                    else:
                        await qout.put(_Msg(msg.idx, p, ready_at=clock.now,
                                            data_done=clock.now,
                                            payload=msg.payload))
                else:                                    # Fig. 4 overlap
                    await clock.sleep(off)
                    await qout.put(_Msg(msg.idx, p, ready_at=clock.now,
                                        data_done=clock.now,
                                        payload=msg.payload))
                    await clock.sleep(comp - off)
                    await clock.sleep_until(data_done)

        async def link_worker(k: int, qin: HopQueue, qout: HopQueue):
            link = self.links[k] if k < len(self.links) else None
            emit = sink.span if sink is not None else None
            migrate = self.migrate
            lres = ("link", k)
            nres = ("compute", k + 1)
            while True:
                msg = await qin.get()
                if msg is _STOP:
                    await qout.put(_STOP)
                    return
                await clock.sleep_until(msg.ready_at)    # tx_ready
                if migrate is not None:
                    # the hook sees exactly the simulator's arguments
                    # (the task's own boundary-ready instant, never the
                    # clock), so both engines switch plans identically
                    newp = migrate(msg.idx, k, msg.ready_at)
                    if newp is not None:
                        assert len(newp.tx) == self.n_hops \
                            and newp.exit_hop == msg.plan.exit_hop, \
                            "migrated plan must preserve hop count " \
                            "and exit hop"
                        msg.plan = newp
                        if emit is not None:
                            emit((REPLAN, lres, msg.ready_at, msg.ready_at,
                                  msg.idx, None, None, None, k))
                t_start = clock.now
                dur = msg.plan.tx[k]
                if link is not None and link.trace is not None and dur > 0:
                    # re-integrate the planned bit volume at the actual start
                    bits = dur * link.bandwidth_bps
                    dur = link.transfer_time(bits, t_start)
                t_done = t_start + dur
                roff = msg.plan.rx_offset[k]
                c_ready = t_done if roff is None \
                    else max(t_start + roff, msg.ready_at)
                link_busy[k] += dur
                link_iv[k].append((t_start, t_done))
                if emit is not None:
                    emit((XFER, lres, t_start, t_done, msg.idx, None,
                          msg.ready_at))
                # hold the packet until the receiver may start, then forward
                # while (possibly) still transmitting the tail
                fwd = min(max(c_ready - t_start, 0.0), dur)
                await clock.sleep(fwd)
                if emit is not None:
                    t = clock.now
                    emit((ENQUEUE, nres, t, t, msg.idx))
                await qout.put(_Msg(msg.idx, msg.plan, ready_at=c_ready,
                                    data_done=t_done, payload=msg.payload))
                await clock.sleep(dur - fwd)

        async def main():
            # queue j feeds resource j in the alternating chain
            # compute_0, link_0, compute_1, ..., link_{n-1}, compute_n
            queues = [HopQueue(clock, self.capacity)
                      for _ in range(2 * n_hops + 1)]
            workers = [clock.spawn(admit_fn(queues[0], credits, record)
                                   if admit_fn is not None
                                   else admit(queues[0]))]
            for k in range(n_seg):
                qout = queues[2 * k + 1] if k < n_hops else None
                workers.append(clock.spawn(
                    compute_worker(k, queues[2 * k], qout)))
            for k in range(n_hops):
                workers.append(clock.spawn(
                    link_worker(k, queues[2 * k + 1], queues[2 * k + 2])))
            await asyncio.gather(*workers)

        self.clock.run(main())
        # batch sizes are only meaningful when batching is on; emit ()
        # otherwise so unbatched runs stay field-identical to the
        # legacy simulator output
        batching = any(c > 1 for c in self.batch_caps)
        return sim.StreamResult(
            arrivals=arrs, done=done,
            early_exit=[eh is not None for eh in exit_hops],
            makespan=max(done) - min(arrs),
            compute_busy=tuple(comp_busy), link_busy=tuple(link_busy),
            compute_intervals=tuple(tuple(iv) for iv in comp_iv),
            link_intervals=tuple(tuple(iv) for iv in link_iv),
            exit_hop=exit_hops,
            compute_batch_sizes=tuple(tuple(b) for b in comp_bs)
            if batching else ())

    def _run_pool(self, plan_fn, n_tasks: int,
                  arrivals: Optional[Sequence[float]],
                  payloads: Optional[Sequence[Any]] = None,
                  admit_fn: Optional[Callable] = None
                  ) -> sim.PoolStreamResult:
        """Replicated-tier topology: per tier one dispatcher worker, one
        worker per replica, and (before each hop link) one sequencer
        worker restoring admission order (see the module correspondence
        table).  Differentially pinned to ``sim.simulate_pool_stream``."""
        assert n_tasks > 0
        assert admit_fn is not None or (arrivals is not None
                                        and len(arrivals) >= n_tasks)
        clock = self.clock
        n_hops, n_seg = self.n_hops, self.n_seg
        pools, router = self.pools, self.router
        router.reset(pools)
        replica_busy: List[List[float]] = [[0.0] * p.m for p in pools]
        replica_iv: List[List[List[sim.Interval]]] = \
            [[[] for _ in range(p.m)] for p in pools]
        replica_bs: List[List[List[int]]] = \
            [[[] for _ in range(p.m)] for p in pools]
        link_busy = [0.0] * n_hops
        link_iv: List[List[sim.Interval]] = [[] for _ in range(n_hops)]
        done = [0.0] * n_tasks
        exit_hops: List[Optional[int]] = [None] * n_tasks
        routes: List[List[Optional[int]]] = \
            [[None] * n_seg for _ in range(n_tasks)]
        arrs = [0.0] * n_tasks if admit_fn is not None \
            else list(arrivals[:n_tasks])
        self.outputs = {}
        credits = HopQueue(clock) if admit_fn is not None else None
        sink = self.sink

        def record(idx: int, arrival: float):
            arrs[idx] = arrival

        async def admit(q0: HopQueue):
            emit = sink.span if sink is not None else None
            res0 = ("compute", 0)
            for i in range(n_tasks):
                arr = arrivals[i]
                await clock.sleep_until(arr)
                plan = plan_fn(i, arr)
                if isinstance(plan, TaskPlan):
                    plan = plan.as_sim_plan(n_hops)
                assert len(plan.tx) == n_hops, "plan/deployment hop mismatch"
                payload = payloads[i] if payloads is not None else None
                if emit is not None:
                    t = clock.now
                    emit((ENQUEUE, res0, t, t, i))
                await q0.put(_Msg(i, plan, ready_at=arr, data_done=arr,
                                  payload=payload))
            await q0.put(_STOP)

        async def dispatcher(k: int, qin: HopQueue,
                             rqs: Sequence[HopQueue]):
            # routes in strict queue (= admission) order; decisions read
            # only the message's carried ready time and the router's own
            # per-tier state, never the clock, so they match the staged
            # simulator's placements exactly
            seq = 0
            emit = sink.span if sink is not None else None
            while True:
                msg = await qin.get()
                if msg is _STOP:
                    for rq in rqs:
                        await rq.put(_STOP)
                    return
                r = router.route(k, msg.ready_at, msg.plan.compute[k],
                                 msg.tenant)
                routes[msg.idx][k] = r
                msg.seq = seq
                seq += 1
                if emit is not None:
                    # the placement is a function of the message, not the
                    # clock, so the span is stamped at the task's ready
                    # instant — identically to the staged dispatch
                    t = msg.ready_at
                    emit((ROUTE, ("compute", k, r), t, t, msg.idx, None,
                          t, None, None, r, msg.seq))
                await rqs[r].put(msg)

        async def replica_worker(k: int, r: int, qin: HopQueue,
                                 sq: Optional[HopQueue]):
            # the chain compute worker, speed-scaled; completions are
            # released to the pool's sequencer as (seq, msg | None)
            emit = sink.span if sink is not None else None
            res = ("compute", k, r)
            cap = self.batch_caps[k]
            speed = pools[k].speeds[r]
            while True:
                if k == 0 and credits is not None:
                    await credits.put(None)
                msg = await qin.get()
                if msg is _STOP:
                    if sq is not None:
                        await sq.put(_STOP)
                    return
                if cap > 1:
                    # membership against this replica's queue at the wake
                    # instant (same rule as the chain batching worker)
                    await clock.settle()
                    cand = [msg]
                    for m in qin.snapshot():
                        if m is _STOP:
                            break
                        cand.append(m)
                    await clock.sleep_until(msg.ready_at)
                    s = clock.now
                    n_b = sim.greedy_batch_size(
                        k, cap, s, [m.plan for m in cand],
                        [m.ready_at for m in cand], speed=speed)
                    if n_b > 1:
                        batch = [msg] + qin.drain(n_b - 1)
                        dur = speed * sim.batched_service_time(
                            [m.plan for m in batch], k)
                        if self.segment_fn is not None:
                            for m in batch:
                                m.payload = self.segment_fn(
                                    k, m.idx, m.payload)
                        replica_busy[k][r] += dur
                        replica_iv[k][r].append((s, s + dur))
                        replica_bs[k][r].append(len(batch))
                        if emit is not None:
                            emit((SERVICE, res, s, s + dur, msg.idx,
                                  tuple(m.idx for m in batch),
                                  msg.ready_at, len(batch)))
                            for m in batch[1:]:
                                if s > m.ready_at:
                                    emit((BATCH_FORM, res, m.ready_at, s,
                                          m.idx))
                        await clock.sleep(dur)
                        for m in batch:
                            await clock.sleep_until(m.data_done)
                            p = m.plan
                            if k == n_hops or (p.exit_hop is not None
                                               and k >= p.exit_hop):
                                done[m.idx] = clock.now
                                exit_hops[m.idx] = p.exit_hop
                                self.outputs[m.idx] = m.payload
                                if emit is not None \
                                        and p.exit_hop is not None:
                                    t = clock.now
                                    emit((EXIT_RELEASE, res, t, t, m.idx,
                                          None, None, None, p.exit_hop))
                                if sq is not None:
                                    await sq.put((m.seq, None))
                            else:
                                await sq.put((m.seq, _Msg(
                                    m.idx, p, ready_at=clock.now,
                                    data_done=clock.now,
                                    payload=m.payload, tenant=m.tenant)))
                        continue
                await clock.sleep_until(msg.ready_at)
                start = clock.now             # = max(ready, replica free)
                p = msg.plan
                comp = speed * p.compute[k]
                if self.segment_fn is not None:
                    msg.payload = self.segment_fn(k, msg.idx, msg.payload)
                replica_busy[k][r] += comp
                replica_iv[k][r].append((start, start + comp))
                replica_bs[k][r].append(1)
                if emit is not None:
                    emit((SERVICE, res, start, start + comp, msg.idx,
                          (msg.idx,), msg.ready_at, 1))
                data_done = msg.data_done
                last = k == n_hops or \
                    (p.exit_hop is not None and k >= p.exit_hop)
                off = None if last else p.tx_offset[k]
                if last or off is None or off >= comp:   # serial stage
                    await clock.sleep(comp)
                    await clock.sleep_until(data_done)   # c_done gate
                    if last:
                        done[msg.idx] = clock.now
                        exit_hops[msg.idx] = p.exit_hop
                        self.outputs[msg.idx] = msg.payload
                        if emit is not None and p.exit_hop is not None:
                            t = clock.now
                            emit((EXIT_RELEASE, res, t, t, msg.idx,
                                  None, None, None, p.exit_hop))
                        if sq is not None:
                            await sq.put((msg.seq, None))
                    else:
                        await sq.put((msg.seq, _Msg(
                            msg.idx, p, ready_at=clock.now,
                            data_done=clock.now, payload=msg.payload,
                            tenant=msg.tenant)))
                else:                                    # Fig. 4 overlap
                    await clock.sleep(off)
                    await sq.put((msg.seq, _Msg(
                        msg.idx, p, ready_at=clock.now,
                        data_done=clock.now, payload=msg.payload,
                        tenant=msg.tenant)))
                    await clock.sleep(comp - off)
                    await clock.sleep_until(data_done)

        async def sequencer(k: int, sq: HopQueue, qout: HopQueue, m: int):
            # restore admission order toward the serial hop link: buffer
            # out-of-order releases, forward strictly by seq (a terminal
            # release — (seq, None) — just advances the cursor); the
            # forward instant is therefore the running max of release
            # instants, the expression the simulator's sequencer stage
            # computes
            buf: dict = {}
            next_seq = 0
            stops = 0
            emit = sink.span if sink is not None else None
            lres = ("link", k)
            while True:
                item = await sq.get()
                if item is _STOP:
                    stops += 1
                    if stops == m:
                        assert not buf, "sequencer stopped with buffered " \
                            "tasks (replica lost a release)"
                        await qout.put(_STOP)
                        return
                    continue
                s_id, out = item
                # the get returns at the release's put instant (the
                # sequencer never sleeps between gets, so the clock
                # cannot advance past a queued release) — stamp it as
                # the release instant for the hold span
                buf[s_id] = (out, clock.now)
                while next_seq in buf:
                    nxt, rel = buf.pop(next_seq)
                    next_seq += 1
                    if nxt is not None:
                        # forward instant = running max of releases; any
                        # excess over this task's own release is the
                        # sequencer restoring admission order
                        if emit is not None and clock.now > rel:
                            emit((SEQ_HOLD, lres, rel, clock.now,
                                  nxt.idx))
                        await qout.put(nxt)

        async def link_worker(k: int, qin: HopQueue, qout: HopQueue):
            link = self.links[k] if k < len(self.links) else None
            emit = sink.span if sink is not None else None
            lres = ("link", k)
            nres = ("compute", k + 1)
            while True:
                msg = await qin.get()
                if msg is _STOP:
                    await qout.put(_STOP)
                    return
                await clock.sleep_until(msg.ready_at)    # tx_ready
                t_start = clock.now
                dur = msg.plan.tx[k]
                if link is not None and link.trace is not None and dur > 0:
                    bits = dur * link.bandwidth_bps
                    dur = link.transfer_time(bits, t_start)
                t_done = t_start + dur
                roff = msg.plan.rx_offset[k]
                c_ready = t_done if roff is None \
                    else max(t_start + roff, msg.ready_at)
                link_busy[k] += dur
                link_iv[k].append((t_start, t_done))
                if emit is not None:
                    emit((XFER, lres, t_start, t_done, msg.idx, None,
                          msg.ready_at))
                fwd = min(max(c_ready - t_start, 0.0), dur)
                await clock.sleep(fwd)
                if emit is not None:
                    t = clock.now
                    emit((ENQUEUE, nres, t, t, msg.idx))
                await qout.put(_Msg(msg.idx, msg.plan, ready_at=c_ready,
                                    data_done=t_done, payload=msg.payload,
                                    tenant=msg.tenant))
                await clock.sleep(dur - fwd)

        async def main():
            # per tier: pool input queue -> dispatcher -> replica queues
            # -> replicas -> sequencer -> hop link -> next pool input
            pin = [HopQueue(clock, self.capacity) for _ in range(n_seg)]
            workers = [clock.spawn(admit_fn(pin[0], credits, record)
                                   if admit_fn is not None
                                   else admit(pin[0]))]
            for k in range(n_seg):
                m = pools[k].m
                rqs = [HopQueue(clock, self.capacity) for _ in range(m)]
                sq = HopQueue(clock) if k < n_hops else None
                workers.append(clock.spawn(dispatcher(k, pin[k], rqs)))
                for r in range(m):
                    workers.append(clock.spawn(
                        replica_worker(k, r, rqs[r], sq)))
                if k < n_hops:
                    lq = HopQueue(clock, self.capacity)
                    workers.append(clock.spawn(sequencer(k, sq, lq, m)))
                    workers.append(clock.spawn(
                        link_worker(k, lq, pin[k + 1])))
            await asyncio.gather(*workers)

        self.clock.run(main())
        return sim.PoolStreamResult(
            arrivals=arrs, done=done,
            early_exit=[eh is not None for eh in exit_hops],
            exit_hop=exit_hops,
            makespan=max(done) - min(arrs),
            link_busy=tuple(link_busy),
            link_intervals=tuple(tuple(iv) for iv in link_iv),
            replica_busy=tuple(tuple(rb) for rb in replica_busy),
            replica_intervals=tuple(tuple(tuple(iv) for iv in tier)
                                    for tier in replica_iv),
            replica_batch_sizes=tuple(tuple(tuple(bs) for bs in tier)
                                      for tier in replica_bs),
            routes=tuple(tuple(rt) for rt in routes),
            pools=pools)


def run_pipeline_async(plans: Sequence[TaskPlan],
                       arrivals: Optional[Sequence[float]] = None,
                       arrival_period: float = 0.0,
                       link: Optional[LinkProfile] = None,
                       links: Optional[Sequence[Optional[LinkProfile]]] = None,
                       queue_capacity: int = 0,
                       clock=None,
                       segment_fn=None,
                       payloads: Optional[Sequence[Any]] = None,
                       batch_caps: Optional[Sequence[int]] = None,
                       pools=None, router=None, sink=None,
                       migrate=None) -> PipelineResult:
    """Async-executor counterpart of ``core.pipeline.run_pipeline``: same
    plan normalization and result type, but the stream is *executed* by
    per-resource workers instead of replayed by ``simulate_stream``.
    With ``queue_capacity = 0`` (unbounded) and a ``VirtualClock`` the
    two timelines agree to float precision (including per-tier
    micro-batching via ``batch_caps``).  ``pools`` + ``router`` spawn one
    worker per replica behind per-pool dispatchers and pin against
    ``sim.simulate_pool_stream`` instead.  ``sink`` (a
    ``repro_torch.obs.trace`` span sink) records the executed timeline; the
    same call against ``core.pipeline.run_pipeline`` yields a matching
    trace (``assert_traces_match``).  ``migrate`` is the online
    re-planning hook (see ``sim.simulate_stream``); passing the same
    hook object (reset between runs) to both entry points keeps the
    differential pin across mid-stream plan switches."""
    n = len(plans)
    if arrivals is None:
        arrivals = [i * arrival_period for i in range(n)]
    if links is None:
        links = [link]
    n_hops = max(max(p.n_hops for p in plans), len(links))
    sps = [p.as_sim_plan(n_hops) for p in plans]
    pipe = AsyncHopPipeline(n_hops, links=links, clock=clock,
                            queue_capacity=queue_capacity,
                            segment_fn=segment_fn,
                            batch_caps=batch_caps,
                            pools=pools, router=router, sink=sink,
                            migrate=migrate)
    res = pipe.run(lambda i, _arr: sps[i], n, arrivals, payloads=payloads)
    if isinstance(res, sim.PoolStreamResult):
        from repro_torch.core.pipeline import result_from_pool_stream
        return result_from_pool_stream(res)
    return result_from_stream(res)


# =================================================================== engine
class AsyncCoachEngine(EngineBase):
    """COACH engine on the async hop-queue executor.

    Identical decision sequence to the sync ``CoachEngine`` (decisions are
    made at enqueue time on the end worker, in task order), but the
    induced plans occupy real per-resource workers: with unbounded queues
    and the virtual clock the timeline is pinned to
    ``core.sim.simulate_stream``; ``cfg.queue_capacity`` bounds the hop
    queues (backpressure), ``cfg.per_hop_bits`` enables per-hop adaptive
    precision from per-hop bandwidth EMAs."""

    def run_stream(self, tasks, arrival_period: float, classify,
                   clock=None) -> EngineStats:
        tasks = list(tasks)
        n = len(tasks)
        n_hops = len(self.links)
        acc = {"exits": 0, "wire": 0.0, "bits": [], "correct": []}

        def admit(i: int, t_arr: float) -> TaskPlan:
            task = tasks[i]
            bw = self.link.bps_at(arrival_period * task.id)
            return self.admit_plan(task, bw, t_arr, classify, acc)

        pipe = AsyncHopPipeline(n_hops, links=self.links, clock=clock,
                                queue_capacity=self.cfg.queue_capacity,
                                batch_caps=self.batch_caps,
                                pools=self.pools, router=self.make_router(),
                                sink=self.cfg.trace,
                                migrate=self.cfg.migrate)
        res = pipe.run(admit, n, [i * arrival_period for i in range(n)])
        if isinstance(res, sim.PoolStreamResult):
            from repro_torch.core.pipeline import result_from_pool_stream
            pr = result_from_pool_stream(res)
        else:
            pr = result_from_stream(res)
        return self._stats(pr, n, acc["exits"], acc["bits"], acc["wire"],
                           acc["correct"])
