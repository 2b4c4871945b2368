"""95th percentile of the served tasks' latencies (due time to the
return of ``account``), ms; a failed task's latency is infinite."""

import math

from perfbench.harness.stats import percentile


def read(run):
    v = percentile(run.latencies(), 95) * 1e3
    return v if math.isfinite(v) else None
