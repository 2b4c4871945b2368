"""The share of the profiled stretch's busy device time in which two or
more device operations ran at once, %: on the pipelined step, the part
of the step in which both pods' kernels are in flight (each pod's
operations are one chain on a stream of its own)."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * run.trace["overlap_s"] / run.trace["busy_s"]
