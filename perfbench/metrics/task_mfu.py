"""Model flops of the served tasks (``perfbench/flops/<kind>.py``) over
their summed service time (start of service to the answer) times the
card's fp32 peak outside the tensor cores, %."""

from perfbench.harness.work import PEAK_FP32_FLOPS


def read(run):
    ok = [r for r in run.records if r.ok]
    busy = sum(r.end - r.start for r in ok)
    if not ok or busy <= 0:
        return None
    return 100.0 * run.flops_per_task * len(ok) / (busy * PEAK_FP32_FLOPS)
