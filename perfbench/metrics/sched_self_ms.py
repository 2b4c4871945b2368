"""Median over the profiled stretch's tasks of the scheduler's own host
ms, from the program's spans (``serving/base.py``): ``decide`` less its
``classify`` child (the caller's model run), plus ``plan_for`` and
``account``.  The same quantity as ``sched_host_ms``, which the harness
times from outside."""

from perfbench.metrics._program_spans import median_ms


def read(run):
    return median_ms(run, ("decide", "plan_for", "account"),
                     less=("classify",))
