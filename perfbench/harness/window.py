"""The measured window: the harness's own single-threaded loop, which
drives the cell's driver (``perfbench/drivers/<driver>.py``) one task at
a time.

Open loop (``due`` given): tasks are served in FIFO order; a task not yet
due is waited for, a due one is served at once, so the queue's wait is
inside each latency (due time to the task's answer) and a stall
delays every task behind it.  Every task due in the window is served,
however long past its close that takes.

Closed loop (``due`` None): one client sends its next task when the last
is answered, until the window's seconds are up; the task in flight then
is finished.

A seeded reservoir keeps the outputs of ``SAMPLE`` tasks (a served
split's packets and logits), uniform over the tasks served, for the
comparison with the reference.

With ``trace``, a steady stretch of ``TRACE_TASKS`` tasks from 40% into
the window runs under ``torch.profiler``, the host's phases as ``pb.*``
spans; the rest of the window runs as an untraced run does."""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import List, Optional

import numpy as np

TRACE_TASKS = 32
SAMPLE = 16


def span(name: str, on: bool):
    """A profiler span named ``pb.<name>`` when the run is traced; the
    trace reader names the device's idle gaps by these."""
    if not on:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(f"pb.{name}")


@dataclasses.dataclass
class Record:
    """One task of the window; a driver's records add what it produced."""
    idx: int
    task: object
    due: float = 0.0          # host clock (s): due (open) or sent (closed)
    start: float = 0.0        # service start
    end: float = math.inf     # the answer
    ok: bool = False

    def drop(self):
        """Forget the outputs kept for the comparison."""


class Profile:
    """``torch.profiler`` over a stretch of the window."""

    def __init__(self):
        import warnings

        import torch
        warnings.filterwarnings("ignore", message=".*clears events.*")
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.first = None
        self.tasks = 0
        self.closed = False

    def start(self, first: int):
        self.first = first
        self.prof.start()
        self._span = span("window", True)
        self._span.__enter__()

    def stop(self, last: int):
        import torch
        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.stop()
        self.tasks = last - self.first
        self.closed = True

    @property
    def active(self) -> bool:
        return self.first is not None and not self.closed


def warm_profiler(driver):
    """One short profile in set-up, so that the profiler's own start-up
    is not paid inside the window."""
    p = Profile()
    p.start(0)
    driver.warm_up()
    p.stop(0)


class Reservoir:
    """Algorithm R over the task indices, from the seed."""

    def __init__(self, seed: int, k: int = SAMPLE):
        self.rng = np.random.default_rng([seed, 2])
        self.k = k
        self.slots: List[Record] = []

    def admit(self, rec: Record) -> bool:
        """Whether to keep ``rec``'s outputs; evicts the one it replaces."""
        if len(self.slots) < self.k:
            self.slots.append(rec)
            return True
        j = int(self.rng.integers(0, rec.idx + 1))
        if j >= self.k:
            return False
        self.slots[j].drop()
        self.slots[j] = rec
        return True


def sample_of(seed: int, n: int) -> List[int]:
    """The indices a run's reservoir keeps of ``n`` served tasks."""
    res = Reservoir(seed)
    for i in range(n):
        res.admit(Record(i, None))
    return [r.idx for r in res.slots]


def run(driver, seed: int, seconds: float, due: Optional[List[float]],
        trace: bool) -> dict:
    """``driver.serve(rec, keep)`` for each task, ``keep`` saying whether
    to keep its outputs for the comparison; it sets ``rec.end`` and
    ``rec.ok``, and a task that raises counts as failed."""
    recs: List[Record] = []
    failures: List[str] = []
    sample = Reservoir(seed)
    prof = Profile() if trace else None
    tasks = driver.draw(len(due)) if due is not None else None
    t0 = time.perf_counter()
    while True:
        i = len(recs)
        now = time.perf_counter()
        if due is not None:
            if i == len(due):
                break
            rec = driver.record(i, tasks[i], t0 + due[i])
            start_trace = prof is not None and prof.first is None \
                and due[i] >= 0.4 * seconds
        else:
            if now - t0 >= seconds:
                break
            rec = driver.record(i, driver.draw(1)[0], now)
            start_trace = prof is not None and prof.first is None \
                and now - t0 >= 0.4 * seconds
        if start_trace:
            prof.start(i)
        if now < rec.due:
            with span("wait", prof is not None and prof.active):
                time.sleep(rec.due - now)
        rec.start = time.perf_counter()
        keep = sample.admit(rec)
        try:
            driver.serve(rec, keep)
            if not rec.ok:
                failures.append(f"task {i}: its answer is not finite")
        except Exception as e:  # a task that raises counts as failed
            rec.end, rec.ok = math.inf, False
            failures.append(f"task {i}: {type(e).__name__}: {e}")
        recs.append(rec)
        if prof is not None and prof.active \
                and i + 1 - prof.first >= TRACE_TASKS:
            prof.stop(i + 1)
    if prof is not None and prof.active:
        prof.stop(len(recs))
    t1 = time.perf_counter()
    return {"records": recs, "t0": t0, "t1": t1, "failures": failures,
            "sample": [r.idx for r in sample.slots],
            "profile": prof if prof is not None and prof.closed else None}
