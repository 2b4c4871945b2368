"""What the readers of the program's own wall-clock spans share: the
spans that ``repro_torch.obs.runtime`` recorded for the tasks of the
profiled stretch (``run.records[a:b]``, ``(a, b) = run.trace_range``,
matched by task id).  The recorder records while the profiler does.  A
program without the recorder, a run with no profiled stretch, or no span
of those tasks gives None."""


def median_ms(run, names, less=()):
    """The median over the profiled tasks of the host ms in each task's
    spans named in ``names``, less that in those named in ``less``; None
    when no task has one."""
    if run.trace_range is None:
        return None
    try:
        from repro_torch.obs import runtime as RT
    except ImportError:  # a program that has no recorder
        return None
    a, b = run.trace_range
    return RT.median_ms(RT.RECORDER.spans(),
                        [r.task.id for r in run.records[a:b]], names, less)
