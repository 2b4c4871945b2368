"""Median over the profiled stretch's tasks of the runtime's own host ms:
the program's ``segment`` spans (``core/collab.py``'s ``segment_step``:
the K1 / K2 launches and the segments' ``jit`` calls: key, input copies,
graph launch, output clones), less their ``jit.replay`` spans, the graph
launches, which the profiler itself slows by milliseconds a task
(``repro_torch.obs.runtime``)."""

from perfbench.metrics._program_spans import median_ms


def read(run):
    return median_ms(run, ("segment",), less=("jit.replay",))
