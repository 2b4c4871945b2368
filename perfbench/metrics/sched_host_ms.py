"""Median host ms a task spends in ``decide`` + ``plan_for`` +
``account`` outside ``classify`` (the harness's timestamps), over the
tasks outside the profiled stretch."""

import statistics


def read(run):
    xs = [r.sched_s for r in run.untraced() if r.ok]
    return statistics.median(xs) * 1e3 if xs else None
