"""Trace export: Chrome/Perfetto ``trace_event`` JSON + text summaries.

``to_chrome_trace`` maps a span trace onto the Chrome trace-event
format (https://ui.perfetto.dev loads it directly): one process per
pipeline, one thread row per resource in chain order, complete
(``"ph": "X"``) events for busy/wait spans and instant (``"ph": "i"``)
events for points.  When an ``Attribution`` is supplied, each
resource additionally gets a ``<label>/bubbles`` row whose events are
the attributed idle gaps named by cause — the "why is this row empty"
answer rendered right under the timeline.

Timestamps are converted from seconds to the format's microseconds.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.bubbles import Attribution
from repro_torch.obs.trace import (BATCH_FORM, CREDIT_WAIT, SEQ_HOLD, SERVICE,
                             XFER, Resource, canonical, is_link,
                             resource_label, tier_of)

__all__ = ["to_chrome_trace", "write_chrome_trace", "text_summary"]

_US = 1e6
_DUR_KINDS = (SERVICE, XFER, SEQ_HOLD, CREDIT_WAIT, BATCH_FORM)
_WAIT_KINDS = (SEQ_HOLD, CREDIT_WAIT, BATCH_FORM)


def _resource_order(res: Resource):
    # chain order: compute0 replicas, link0, compute1 replicas, ...
    return (tier_of(res), 1 if is_link(res) else 0,
            res[2] if len(res) > 2 else -1)


def to_chrome_trace(trace, attribution: Optional[Attribution] = None,
                    pid: int = 1) -> dict:
    """Render a trace (and optional attribution) as a trace-event dict."""
    spans = canonical(trace)
    rows: Dict[str, int] = {}

    def tid_of(label: str) -> int:
        if label not in rows:
            rows[label] = len(rows) + 1
        return rows[label]

    # register busy rows first, in chain order, so the viewer lays the
    # pipeline out top-to-bottom
    for res in sorted({s.resource for s in spans
                       if s.kind in (SERVICE, XFER)}, key=_resource_order):
        tid_of(resource_label(res))

    events: List[dict] = []
    for s in spans:
        label = resource_label(s.resource)
        if s.kind in _WAIT_KINDS:
            label += "/waits"
        args = {k: v for k, v in (("task", s.task), ("tasks", s.tasks),
                                  ("ready", s.ready), ("batch", s.batch),
                                  ("hop", s.hop), ("replica", s.replica),
                                  ("seq", s.seq)) if v is not None}
        ev = {"name": s.kind if s.kind in _DUR_KINDS
              else f"{s.kind}#{s.task}",
              "cat": s.kind, "pid": pid, "tid": tid_of(label),
              "ts": s.t0 * _US, "args": args}
        if s.kind in _DUR_KINDS:
            ev["ph"] = "X"
            ev["dur"] = max(0.0, (s.t1 - s.t0) * _US)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)

    if attribution is not None:
        for b in attribution.bubbles:
            label = resource_label(b.resource) + "/bubbles"
            events.append({"name": b.cause, "cat": "bubble", "ph": "X",
                           "pid": pid, "tid": tid_of(label),
                           "ts": b.t0 * _US,
                           "dur": max(0.0, b.dur * _US),
                           "args": {} if b.task is None
                           else {"task": b.task}})

    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": "pipeline"}}]
    meta.extend({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": label}} for label, tid in rows.items())
    meta.extend({"name": "thread_sort_index", "ph": "M", "pid": pid,
                 "tid": tid, "args": {"sort_index": tid}}
                for tid in rows.values())
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, trace,
                       attribution: Optional[Attribution] = None) -> str:
    """Write the trace-event JSON to ``path``; returns the path."""
    doc = to_chrome_trace(trace, attribution)
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)


def text_summary(attribution: Attribution,
                 unit: float = 1e3, unit_name: str = "ms") -> str:
    """Per-resource, per-cause table (plus busy and conservation check).

    ``unit`` scales seconds into the displayed unit (default ms).
    """
    secs = attribution.seconds()
    causes = [c for c in next(iter(secs.values()), {})]
    if not causes:
        return "(empty trace)"
    active = [c for c in causes
              if any(cs[c] > 0.0 for cs in secs.values())]
    head = ["resource", f"busy_{unit_name}"] + \
        [f"{c}_{unit_name}" for c in active] + ["bubble_frac"]
    h = attribution.horizon_s
    lines = ["  ".join(f"{x:>22}" if i == 0 else f"{x:>15}"
                       for i, x in enumerate(head))]
    for res in attribution.resources():
        busy = attribution.busy[res]
        row = [resource_label(res), f"{busy * unit:.3f}"]
        row += [f"{secs[res][c] * unit:.3f}" for c in active]
        row.append(f"{(1.0 - busy / h) if h > 0 else 0.0:.3f}")
        lines.append("  ".join(f"{x:>22}" if i == 0 else f"{x:>15}"
                               for i, x in enumerate(row)))
    lines.append(f"horizon = {h * unit:.3f} {unit_name}; max "
                 f"|busy + bubbles - horizon| = "
                 f"{attribution.max_conservation_error():.2e} s")
    return "\n".join(lines)
