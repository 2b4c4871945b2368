"""Host launches a task over the window: graph replays, the jit's input
copies and output clones (``core.jit`` counters) and boundary-kernel
launches (``kernels._build.LAUNCHES``)."""


def read(run):
    return run.launches / len(run.records) if run.records else None
