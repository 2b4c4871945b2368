"""COACH serving engine: the full online loop over a continuous task stream.

Wires together every subsystem:

  offline   partition + quantization (core.partitioner) on the model's cost
            graph -> a CollabRuntime split at the chosen group boundaries
            (one cut per hop; classic end->cloud is the single-cut case)
  frontend  task features from the end segment's boundary activation via
            the fused semantic-probe kernel (GAP + cosine + separability)
  online    early exit (Eq. 10) / adaptive precision (Eq. 11) per task
  pipeline  ``2n+1``-resource discrete-event accounting of the induced
            stream (latency / throughput / bubbles), with measured wire
            bytes; non-exit tasks carry one ``TaskPlan`` hop per link

The JAX compute is real (CollabRuntime executes both segments); the
*timing* comes from the calibrated device/link profiles, since this host
is not a Jetson + A6000 pair (DESIGN.md §2).

``CoachEngine`` here is the *synchronous reference*: tasks are decided
and accounted one at a time, with all overlap delegated to
``core.sim.simulate_stream``.  The executor whose real workers overlap
tasks the way the simulator models lives in
``repro_torch.serving.async_engine``; both share ``repro_torch.serving.base``.
"""

from __future__ import annotations

from typing import List

from repro_torch.core.pipeline import run_pipeline
from repro_torch.data.pipeline import Task
from repro_torch.serving.base import EngineBase, EngineConfig, EngineStats

__all__ = ["CoachEngine", "EngineConfig", "EngineStats"]


class CoachEngine(EngineBase):
    """Synchronous reference engine (decision + plan per task, in order)."""

    def run_stream(self, tasks: List[Task], arrival_period: float,
                   classify) -> EngineStats:
        """classify(task) -> (features, predicted_label): the caller runs
        the real model (CollabRuntime) or a proxy; the engine makes the
        COACH decisions — including hop-level semantic exits when the
        engine was built with ``hop_calib`` — and accounts the pipeline
        (decision accounting shared with the async/multi-tenant engines
        via ``EngineBase.account``)."""
        plans = []
        acc = {"exits": 0, "wire": 0.0, "bits": [], "correct": []}
        for i, task in enumerate(tasks):
            bw = self.link.bps_at(arrival_period * task.id)
            dec, feats, pred = self.decide(task, bw, classify)
            plan, wire_bits = self.plan_for(dec, bw)
            if self.batch_slack is not None:
                # same staleness deadline the async engines attach in
                # admit_plan (arrival = i * period in every engine)
                plan.deadline = i * arrival_period + self.batch_slack
            plans.append(plan)
            self.account(dec, feats, pred, task, wire_bits, acc)
        pr = run_pipeline(plans, arrival_period=arrival_period,
                          links=self.links, batch_caps=self.batch_caps,
                          pools=self.pools, router=self.make_router(),
                          sink=self.cfg.trace, migrate=self.cfg.migrate)
        return self._stats(pr, len(tasks), acc["exits"], acc["bits"],
                           acc["wire"], acc["correct"])
