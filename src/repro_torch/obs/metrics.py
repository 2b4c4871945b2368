"""Counters / gauges / histograms registry the engines populate.

``MetricsRegistry`` is deliberately dependency-free (no numpy) and
flat-keyed: ``inc("tier0.route.r1")``, ``observe("tier1.batch_size",
4)``, ``set_gauge("makespan_s", 0.12)``.  The ``populate_from_*``
helpers derive the standard serving metrics from a finished run —
per-tier queue-wait and realized batch-size histograms, router-choice
counters, per-cause bubble seconds — so callers can hang one registry
on ``EngineConfig.metrics`` and read everything back after
``run_stream``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.obs.bubbles import Attribution
from repro_torch.obs.trace import (BATCH_FORM, CREDIT_WAIT, ENQUEUE, EXIT_RELEASE,
                             ROUTE, SEQ_HOLD, SERVICE, XFER, resource_label,
                             spans_of, tier_of)

__all__ = ["MetricsRegistry", "populate_from_trace",
           "populate_from_attribution", "populate_from_result"]


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    i = min(len(ys) - 1, max(0, int(round(q * (len(ys) - 1)))))
    return ys[i]


class MetricsRegistry:
    """Flat-keyed counters, gauges, and histograms."""

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}

    # ------------------------------------------------------------ write
    def inc(self, name: str, v: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + v

    def set_gauge(self, name: str, v: float) -> None:
        self.gauges[name] = float(v)

    def observe(self, name: str, v: float) -> None:
        self._hists.setdefault(name, []).append(float(v))

    # ------------------------------------------------------------- read
    def counter(self, name: str) -> float:
        return self.counters.get(name, 0.0)

    def histogram(self, name: str) -> Dict[str, float]:
        xs = self._hists.get(name, [])
        return {"count": float(len(xs)),
                "sum": sum(xs),
                "mean": sum(xs) / len(xs) if xs else 0.0,
                "p50": _percentile(xs, 0.50),
                "p99": _percentile(xs, 0.99),
                "max": max(xs) if xs else 0.0}

    def snapshot(self) -> dict:
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {n: self.histogram(n) for n in self._hists}}

    def render(self) -> str:
        snap = self.snapshot()
        lines = []
        for name in sorted(snap["counters"]):
            lines.append(f"counter {name} = {snap['counters'][name]:g}")
        for name in sorted(snap["gauges"]):
            lines.append(f"gauge   {name} = {snap['gauges'][name]:g}")
        for name in sorted(snap["histograms"]):
            h = snap["histograms"][name]
            lines.append(f"hist    {name}: n={h['count']:g} "
                         f"mean={h['mean']:g} p50={h['p50']:g} "
                         f"p99={h['p99']:g} max={h['max']:g}")
        return "\n".join(lines)


def populate_from_trace(reg: MetricsRegistry, trace) -> None:
    """Standard span-derived metrics: queue waits, batch sizes, router
    choices, hold/credit waits, exit counts, per-resource busy."""
    for s in spans_of(trace):
        k = tier_of(s.resource)
        if s.kind == SERVICE:
            reg.inc(f"tier{k}.batches")
            if s.batch is not None:
                reg.observe(f"tier{k}.batch_size", s.batch)
            if s.ready is not None:
                reg.observe(f"tier{k}.queue_wait_s", s.t0 - s.ready)
            reg.inc(f"busy_s.{resource_label(s.resource)}", s.t1 - s.t0)
        elif s.kind == XFER:
            reg.inc(f"link{k}.xfers")
            reg.inc(f"busy_s.link{k}", s.t1 - s.t0)
            if s.ready is not None:
                reg.observe(f"link{k}.queue_wait_s", s.t0 - s.ready)
        elif s.kind == ROUTE:
            reg.inc(f"tier{k}.route.r{s.replica}")
        elif s.kind == BATCH_FORM:
            reg.observe(f"tier{k}.batch_form_wait_s", s.t1 - s.t0)
        elif s.kind == SEQ_HOLD:
            reg.observe(f"link{k}.seq_hold_s", s.t1 - s.t0)
        elif s.kind == CREDIT_WAIT:
            reg.observe("ingress.credit_wait_s", s.t1 - s.t0)
        elif s.kind == EXIT_RELEASE:
            reg.inc(f"exits.hop{s.hop}")
        elif s.kind == ENQUEUE:
            reg.inc(f"tier{k}.enqueues")


def populate_from_attribution(reg: MetricsRegistry,
                              att: Attribution) -> None:
    """Per-cause bubble seconds (``bubble_s.<resource>.<cause>``)."""
    reg.set_gauge("horizon_s", att.horizon_s)
    for res, causes in att.seconds().items():
        label = resource_label(res)
        for cause, secs in causes.items():
            if secs:
                reg.inc(f"bubble_s.{label}.{cause}", secs)


def populate_from_result(reg: MetricsRegistry, pr,
                         pool_sizes: Optional[List[int]] = None) -> None:
    """Gauges from a ``PipelineResult``: makespan, realized batch sizes,
    classic bubble fractions."""
    reg.set_gauge("makespan_s", pr.makespan)
    try:
        from repro_torch.serving.batching import realized_batch_sizes
        for k, b in enumerate(realized_batch_sizes(pr)):
            reg.set_gauge(f"tier{k}.realized_batch", b)
    except Exception:
        pass
    n_tiers = len(pr.compute_intervals)
    for k in range(n_tiers):
        reg.set_gauge(f"bubble_frac.compute{k}",
                      pr.bubble_fraction(("compute", k)))
    for k in range(n_tiers - 1):
        reg.set_gauge(f"bubble_frac.link{k}",
                      pr.bubble_fraction(("link", k)))
