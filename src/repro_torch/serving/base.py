"""Shared machinery of the COACH serving engines.

``EngineBase`` owns everything that must be *identical* between the
synchronous reference engine (``repro_torch.serving.engine.CoachEngine``) and
the async hop-queue engine (``repro_torch.serving.async_engine``): offline
stage times, semantic cache + threshold calibration, the online
scheduler, per-task decision making, and TaskPlan construction.  The two
engines differ only in *how* the resulting plans occupy the ``2n+1``
resources — one task at a time through ``core.sim.simulate_stream``
(sync), or concurrently through per-resource asyncio workers (async) —
so concurrency can never change decisions, only timing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import online as ON
from repro_torch.core import sim
from repro_torch.core.costs import DeviceProfile, LinkProfile
from repro_torch.core.pipeline import PipelineResult, TaskPlan
from repro_torch.core.schedule import StageTimes
from repro_torch.obs import runtime as RT


@dataclasses.dataclass
class EngineConfig:
    bits_levels: Sequence[int] = (3, 4, 5, 6, 8)
    default_bits: int = 8
    update_centers: bool = True
    eps: float = 0.005
    # ---- async hop-queue engine knobs
    queue_capacity: int = 64   # bounded per-hop queue depth (0 = unbounded)
    per_hop_bits: bool = True  # per-hop adaptive precision from hop EMAs
    # ---- continuous micro-batching (compute workers drain their hop
    #      queue into dynamic batches; see serving.batching / core.sim)
    batch_caps: Optional[Sequence[int]] = None  # per-tier caps (None = off)
    batch_fixed: Optional[Sequence[float]] = None  # per-segment fixed secs
    batch_fixed_frac: float = 0.0  # or: fixed = frac * segment time
    batch_slack: Optional[float] = None  # staleness budget (s) past arrival;
    #                                also the auto-finder's SLO slack
    auto_batch: bool = False       # run the batch-size finder at build
    batch_cap_limit: int = 32      # auto-finder search ceiling
    ingress_cap: Optional[int] = None  # clamp tier-0 cap (MT engines: 1);
    #                                the auto finder redistributes a
    #                                hard-clamped tier's slack downstream
    # ---- replicated tiers (pool of replicas per tier + router policy;
    #      see core.sim.PoolSpec / serving.routing)
    pool_sizes: Optional[Sequence[int]] = None  # replicas per tier
    pool_speeds: Optional[Sequence[Sequence[float]]] = None  # per-replica
    #                                service-time multipliers (overrides
    #                                pool_sizes when both are given)
    router: str = "jsq"            # routing policy name (serving.routing)
    router_seed: int = 0           # seed for the router's RNG streams
    # ---- observability (repro_torch.obs): both default to None = fully off,
    #      zero overhead (every emission site guards on ``is not None``)
    trace: Any = None    # span sink (e.g. obs.trace.TraceRecorder); the
    #                      engine's executor emits its timeline into it
    metrics: Any = None  # obs.metrics.MetricsRegistry; populated from the
    #                      run's result (and trace, when both are set)
    # ---- online re-planning (repro_torch.scenarios): migrate(idx, k, tx_ready)
    #      hook consulted at every hop boundary; the same hook (reset
    #      between runs) drives the sim replay and the executor, so the
    #      differential pin extends across mid-stream plan switches.
    #      Chain path only (no pools, no micro-batching).
    migrate: Any = None


@dataclasses.dataclass
class EngineStats:
    pipeline: PipelineResult
    exit_ratio: float
    mean_bits: float
    wire_kb_per_task: float
    accuracy: float

    @property
    def exit_hops(self) -> dict:
        """``{segment: count}`` of hop-level semantic exits (segment 0 =
        the classic end-device exit; >= 1 = an intermediate tier)."""
        return self.pipeline.exit_hop_counts()


class EngineBase:
    """Offline plan + online decision layer shared by both engines."""

    def __init__(self, runtime, stage_times: StageTimes,
                 end_dev: DeviceProfile, link: LinkProfile,
                 cloud_dev: DeviceProfile, n_labels: int,
                 calib_feats: np.ndarray, calib_labels: np.ndarray,
                 cfg: Optional[EngineConfig] = None,
                 boundary_elems: Optional[int] = None,
                 links: Optional[Sequence[LinkProfile]] = None,
                 hop_bits_offline: Optional[Sequence[int]] = None,
                 hop_calib: Optional[Sequence[Tuple[np.ndarray,
                                                    np.ndarray]]] = None):
        """``links`` (one per hop, first = the end device's uplink)
        activates the multi-hop path; omitting it keeps the classic
        end->link->cloud deployment with ``link`` as the only hop.

        ``hop_calib`` activates hop-level semantic early exit: one
        ``(features, labels)`` calibration set per *intermediate* tier
        (segments ``1..n_hops-1``, e.g. ``make_hop_calibration_sets(
        stream, n, n_hops)[1:]``), each calibrating that boundary's own
        semantic cache and exit threshold.  Omitting it keeps the classic
        behavior: the only probe runs on the end device.

        ``hop_bits_offline`` is the offline partition's per-hop boundary
        precision (e.g. the mean of ``decision.all_hop_bits[k]``); it is
        what prices ``stage_times.link[k]`` back to a boundary element
        count, so per-hop adaptive bits retime the *true* wire volume.
        Defaults to ``cfg.default_bits`` on every hop.

        ``cfg`` defaults to a fresh ``EngineConfig`` per engine (a shared
        mutable default instance would leak config edits across engines).
        """
        self.rt = runtime
        self.st = stage_times
        self.links = list(links) if links is not None else [link]
        self.link = self.links[0]
        assert len(self.links) == stage_times.n_hops, \
            "need one link per stage-time hop"
        self.cfg = cfg if cfg is not None else EngineConfig()
        cfg = self.cfg
        dim = calib_feats.shape[1]
        self.cache = ON.SemanticCache(n_labels, dim)
        self.cache.warm_up(calib_feats, calib_labels)
        self.th = ON.calibrate_thresholds(self.cache, calib_feats,
                                          calib_labels, eps=cfg.eps,
                                          bit_levels=cfg.bits_levels)
        elems = boundary_elems or int(calib_feats.shape[1])
        offline_bits = list(hop_bits_offline) if hop_bits_offline is not None \
            else [cfg.default_bits] * self.st.n_hops
        assert len(offline_bits) == self.st.n_hops, \
            "need one offline precision per hop"
        # wire volume of hop k >= 1: the offline plan's occupation of link
        # k priced back to elements at that hop's offline precision
        hop_elems = [int(elems)] + [
            max(1, int(self.st.link[k] * self.links[k].bandwidth_bps
                       / offline_bits[k]))
            for k in range(1, self.st.n_hops)]
        hop_probes = None
        if hop_calib is not None:
            assert len(hop_calib) == self.st.n_hops - 1, \
                "need one calibration set per intermediate tier"
            hop_probes = ON.build_hop_probes(hop_calib, n_labels,
                                             eps=cfg.eps,
                                             bit_levels=cfg.bits_levels)
        self.sched = ON.OnlineScheduler(
            self.cache, self.th, elems, stage_times.T_e, stage_times.T_c,
            update_centers=cfg.update_centers,
            hop_elems=hop_elems, stage_compute=stage_times.compute,
            hop_probes=hop_probes)
        # ---- continuous micro-batching: calibrated per-segment fixed
        # costs + per-tier caps (explicit, or from the auto finder)
        stage_compute = list(stage_times.compute)
        if cfg.batch_fixed is not None:
            self.batch_fixed: Optional[List[float]] = \
                [float(f) for f in cfg.batch_fixed]
            assert len(self.batch_fixed) == len(stage_compute), \
                "need one fixed cost per compute segment"
        elif cfg.batch_fixed_frac > 0.0:
            assert cfg.batch_fixed_frac <= 1.0
            self.batch_fixed = [cfg.batch_fixed_frac * c
                                for c in stage_compute]
        else:
            self.batch_fixed = None
        self.batch_slack = cfg.batch_slack
        self.batch_caps: Optional[List[int]] = \
            [int(c) for c in cfg.batch_caps] \
            if cfg.batch_caps is not None else None
        if cfg.auto_batch and self.batch_caps is None:
            assert self.batch_fixed is not None, \
                "auto_batch needs a fixed-cost calibration " \
                "(batch_fixed / batch_fixed_frac)"
            assert self.batch_slack is not None, \
                "auto_batch needs an SLO slack (batch_slack)"
            from repro_torch.serving.batching import auto_batch_caps
            self.batch_caps = auto_batch_caps(
                stage_compute, self.batch_fixed, self.batch_slack,
                cfg.batch_cap_limit, ingress_cap=cfg.ingress_cap)
        elif cfg.ingress_cap is not None and self.batch_caps:
            self.batch_caps[0] = min(self.batch_caps[0],
                                     int(cfg.ingress_cap))
        # ---- replicated tiers: per-tier replica pools from config
        # (None = the classic single-replica chain).  The engines hand
        # these to the executors together with a serving.routing router.
        if cfg.pool_speeds is not None:
            self.pools: Optional[Tuple[sim.PoolSpec, ...]] = sim.as_pools(
                [tuple(float(s) for s in sp) for sp in cfg.pool_speeds],
                len(stage_compute))
        elif cfg.pool_sizes is not None:
            self.pools = sim.as_pools(
                [int(m) for m in cfg.pool_sizes], len(stage_compute))
        else:
            self.pools = None

    def make_router(self):
        """Fresh router instance from the config (None when the engine
        runs the classic chain).  Fresh per call: router state is a replay
        log, so two runs must never share one instance."""
        if self.pools is None:
            return None
        from repro_torch.serving.routing import make_router
        router = make_router(self.cfg.router, seed=self.cfg.router_seed)
        if self.cfg.metrics is not None:
            router.attach_metrics(self.cfg.metrics)
        return router

    # ------------------------------------------------------------ decisions
    @staticmethod
    def _hop_feats(feats) -> np.ndarray:
        """Normalize classify features to per-boundary rows: a 1-D vector
        becomes the single row every probe reuses; a 2-D array maps row
        ``k`` to the probe at segment ``k``."""
        f = np.asarray(feats)
        return f if f.ndim == 2 else f[None]

    @RT.decide_span
    def decide(self, task, bw: float, classify):
        """One COACH online decision (Eq. 10/11).  ``classify(task) ->
        (features, predicted_label)``: the caller runs the real model
        (CollabRuntime) or a proxy; ``features`` may be a single vector
        or a per-boundary ``(n_probes, dim)`` stack (hop-level exits).
        Identical call sequence in every engine, so a seeded stream
        yields identical decisions.

        A classifier on the fused boundary path returns a third element:
        ``(features, predicted_label, probes)``, where ``probes`` is one
        ``online.ProbeResult`` per boundary (or a single one for the
        classic end-only probe).  The scheduler then consumes the
        precomputed Eq. 8-10 outputs instead of re-deriving similarities
        from the features — the single HBM read that quantized the wire
        packet also decided the task."""
        out = classify(task)
        feats, pred = out[0], out[1]
        probes = out[2] if len(out) > 2 else None
        if probes is not None and isinstance(probes, ON.ProbeResult):
            probes = (probes,)
        hop_feats = self._hop_feats(feats)
        if self.sched.hop_probes:
            dec = self.sched.step_cascade(hop_feats, bandwidth_bps=bw,
                                          probes=probes)
        else:
            dec = self.sched.step(hop_feats[0], bandwidth_bps=bw,
                                  probe=probes[0] if probes else None)
        return dec, feats, pred

    @RT.plan_span
    def plan_for(self, dec: ON.OnlineDecision, bw: float,
                 hop_bits: Optional[Sequence[int]] = None
                 ) -> Tuple[TaskPlan, float]:
        """Build the per-task pipeline plan from an online decision.

        Returns ``(plan, hop0_wire_bits)``.  Without ``hop_bits`` the
        adaptive precision retimes only the end device's uplink and the
        inner hops keep their offline-planned occupation (the sync
        reference semantics); with ``hop_bits`` every hop is retimed from
        its chosen precision and bandwidth EMA (per-hop adaptive bits).
        A hop-level exit (``dec.exit_hop = k >= 1``) carries full-length
        stage durations plus the exit marker: the executors run compute
        ``0..k`` / links ``0..k-1`` and release everything downstream."""
        st = self.st
        bf = self.batch_fixed
        if dec.early_exit:
            return TaskPlan(st.T_e, 0.0, 0.0, True,
                            t_fixed=(bf[0],) if bf else ()), 0.0
        bits = dec.bits or self.cfg.default_bits
        wire_bits = self.sched.elems * bits
        t_tx = wire_bits / bw
        if st.n_hops == 1:
            return TaskPlan(
                st.T_e, t_tx, st.T_c,
                tx_offset=min(st.first_tx_offset, st.T_e),
                cloud_offset=st.cloud_start_offset,
                t_fixed=(bf[0], bf[-1]) if bf else ()), wire_bits
        if hop_bits is None:
            tx: Tuple[float, ...] = (t_tx,) + tuple(st.link[1:])
        else:
            assert len(hop_bits) == st.n_hops
            retimed: List[float] = [t_tx]
            for k in range(1, st.n_hops):
                bw_k = self.sched.hop_bandwidth(k) \
                    or self.links[k].bandwidth_bps
                retimed.append(self.sched.hop_elems[k] * hop_bits[k] / bw_k)
            tx = tuple(retimed)
        return TaskPlan.multihop(
            compute=st.compute, tx=tx,
            tx_offsets=tuple(min(st.tx_offsets[k], st.compute[k])
                             for k in range(st.n_hops)),
            rx_offsets=st.rx_offsets, exit_hop=dec.exit_hop,
            t_fixed=bf if bf else None), wire_bits

    @RT.account_span
    def account(self, dec: ON.OnlineDecision, feats, pred, task,
                wire_bits: float, acc: dict) -> None:
        """Shared decision accounting + label feedback (identical in the
        sync, async, and multi-tenant engines, so the three can never
        diverge).  ``acc`` accumulates ``exits`` (int), ``wire`` (float,
        bits), ``bits`` (list), ``correct`` (list)."""
        hop_feats = self._hop_feats(feats)
        if dec.exit_hop == 0:         # classic end-device exit: no wire
            acc["exits"] += 1
            acc["correct"].append(dec.result == task.label)
            return
        acc["bits"].append(dec.bits or self.cfg.default_bits)
        acc["wire"] += wire_bits
        if dec.exit_hop is not None:  # exited at an intermediate tier
            acc["exits"] += 1
            acc["correct"].append(dec.result == task.label)
            # the tier's result flows back down: refresh the probes the
            # task crossed (the exiting tier already self-updated)
            self.sched.report_label_hops(hop_feats, dec.result,
                                         upto=dec.exit_hop)
        else:                         # full pipeline: true label feedback
            acc["correct"].append(pred == task.label)
            self.sched.report_label_hops(hop_feats, task.label)

    def admit_plan(self, task, bw: float, t_bw: float, classify,
                   acc: dict) -> TaskPlan:
        """One enqueue-time decision + plan, with shared accounting.

        ``bw`` prices the uplink for Eq. 11; ``t_bw`` is the wall/virtual
        time at which the per-hop bandwidths are observed (per-hop
        adaptive bits, when enabled).  ``acc`` accumulates the decision
        aggregates every engine reports: ``exits`` (int), ``wire``
        (float, bits), ``bits`` (list), ``correct`` (list).  Used by the
        async single-stream engine and per-tenant by the multi-tenant
        engine, so decision accounting can never diverge between them."""
        dec, feats, pred = self.decide(task, bw, classify)
        hop_bits = None
        if not dec.early_exit and self.cfg.per_hop_bits \
                and self.st.n_hops > 1:
            for k in range(1, self.st.n_hops):
                self.sched.observe_hop_bandwidth(
                    k, self.links[k].bps_at(t_bw))
            # hop 0 keeps the Eq. 11 choice already in dec.bits
            chosen = self.sched.choose_hop_bits(
                dec.required_bits or self.cfg.default_bits)
            hop_bits = (dec.bits or self.cfg.default_bits,) + chosen[1:]
        plan, wire_bits = self.plan_for(dec, bw, hop_bits=hop_bits)
        if self.batch_slack is not None:
            # staleness deadline from the stream's SLO slack: batch
            # formation never holds this task past it (sim.SimPlan)
            plan.deadline = t_bw + self.batch_slack
        self.account(dec, feats, pred, task, wire_bits, acc)
        return plan

    # ------------------------------------------------------------ reporting
    def _stats(self, pipeline: PipelineResult, n: int, exits: int,
               bits_used: Sequence[int], wire_bits_total: float,
               correct: Sequence[bool]) -> EngineStats:
        if self.cfg.metrics is not None:
            self._populate_metrics(pipeline)
        return EngineStats(
            pipeline=pipeline,
            exit_ratio=exits / n,
            mean_bits=float(np.mean(bits_used)) if bits_used else 0.0,
            wire_kb_per_task=wire_bits_total / 8e3 / n,
            accuracy=float(np.mean(correct)),
        )

    def _populate_metrics(self, pipeline: PipelineResult) -> None:
        """Fill ``cfg.metrics`` from the finished run: result gauges
        always; span-derived counters/histograms and per-cause bubble
        seconds when ``cfg.trace`` recorded the run."""
        from repro_torch.obs.bubbles import attribute, chain_resources
        from repro_torch.obs.metrics import (populate_from_attribution,
                                       populate_from_result,
                                       populate_from_trace)
        reg = self.cfg.metrics
        populate_from_result(reg, pipeline)
        trace = self.cfg.trace
        if trace is not None and len(getattr(trace, "spans", ())) > 0:
            populate_from_trace(reg, trace)
            att = attribute(trace, resources=chain_resources(
                pipeline.n_hops, pipeline.pool_sizes or None))
            populate_from_attribution(reg, att)
