"""Model flops of the completed tasks (a served task, or a pipelined
step: ``perfbench/flops/<kind>.py``) over their summed service time
(start of service to the answer) times the card's dense peak in the
configuration's dtype (the driver's ``peak_flops``, from
``harness/work.py``'s ``PEAK_FLOPS``: fp32 outside the tensor cores,
bf16 on them), %."""


def read(run):
    ok = [r for r in run.records if r.ok]
    busy = sum(r.end - r.start for r in ok)
    if not ok or busy <= 0:
        return None
    return 100.0 * run.flops_per_task * len(ok) / (busy * run.peak_flops)
