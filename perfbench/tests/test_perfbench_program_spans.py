"""The readers of the program's own wall-clock spans
(``runtime_host_ms``, ``sched_self_ms``): each returns its number on a
``Run`` whose recorder (``repro_torch.obs.runtime``) holds spans of the
profiled stretch's tasks, and None when it holds none of them, when the
run has no profiled stretch, or when the program has no recorder.  The
spans are recorded through the recorder's own calls on a clock the test
steps, a replay's device interval through stand-in CUDA events."""

import sys
import types

import pytest

from perfbench.harness.main import Run
from perfbench.harness.window import Record
from perfbench.metrics import runtime_host_ms, sched_self_ms
from repro_torch.obs import runtime as RT

READERS = [runtime_host_ms, sched_self_ms]
MS = 1_000_000  # ns


class Clock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


class Event:
    """A CUDA event stand-in: a pair reads apart the ``Event.ms`` of when
    its end was recorded."""
    ms = 0.0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self, stream=None):
        self.at = Event.ms

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at


class Graph:
    def replay(self):
        pass


@pytest.fixture
def rec(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(RT, "_now", clock)
    monkeypatch.setattr(RT.torch.cuda, "Event", Event)
    monkeypatch.setattr(RT.Recorder, "_current_stream", lambda self: None)
    RT.RECORDER.clear()
    RT.enable()
    yield RT.RECORDER, clock
    RT.disable()
    RT.RECORDER.spans()
    RT.RECORDER.clear()


def serve(rec, clock, task, device_ms):
    """One task's spans, as the served split makes them, every step 1 ms
    of host time: decide 10 ms (classify 8: two segments of 3 ms, each a
    jit whose replay takes 1 ms of host and ``device_ms`` on the device),
    plan_for 1, account 1."""
    def step(ms=1):
        clock.t += ms * MS

    RT._TASK.set(task)
    dec = rec.open("decide")
    step()
    rec.begin("classify")
    for k in (0, 1):
        rec.begin("segment", k)
        step()
        rec.begin("jit")
        Event.ms = device_ms
        rec.replay(Graph())
        step()
        rec.end()
        step()
        rec.end()
    step(2)
    rec.end()
    step()
    rec.close(dec)
    for name in ("plan_for", "account"):
        op = rec.open(name)
        step()
        rec.close(op)
    RT._TASK.set(None)


def make_run(n=8, traced=(2, 5), service_ms=12.0):
    recs = []
    for i in range(n):
        r = Record(i, types.SimpleNamespace(id=100 + i), start=float(i),
                   ok=True)
        r.end = r.start + service_ms / 1e3
        recs.append(r)
    return Run(records=recs, trace_range=traced, window_s=1.0)


def test_each_reader_reads_the_profiled_tasks_spans(rec):
    recorder, clock = rec
    run = make_run()
    for i in range(2, 5):  # the profiled stretch
        serve(recorder, clock, 100 + i, device_ms=2.0 + i)
    serve(recorder, clock, 999, device_ms=50.0)  # a task outside the run
    assert runtime_host_ms.read(run) == 4.0  # 2 x (segment 3 - replay 1)
    assert sched_self_ms.read(run) == 4.0    # decide 10 - classify 8 + 2
    replays = [s for s in recorder.spans() if s.name == "jit.replay"]
    assert [s.device_ms for s in replays] == [4.0] * 2 + [5.0] * 2 \
        + [6.0] * 2 + [50.0] * 2


def test_each_reader_is_none_without_the_profiled_tasks_spans(rec):
    recorder, clock = rec
    run = make_run()
    for reader in READERS:
        assert reader.read(run) is None
    serve(recorder, clock, 100, device_ms=3.0)  # untraced task 0
    serve(recorder, clock, None, device_ms=3.0)  # outside any task
    for reader in READERS:
        assert reader.read(run) is None
    serve(recorder, clock, 103, device_ms=3.0)
    assert runtime_host_ms.read(make_run(traced=None)) is None


def test_the_readers_need_only_the_spans_a_profile_records(rec):
    """Under a profile without ``enable()`` the recorder keeps only the
    spans in ``PROFILED``, and no device interval: the readers read the
    same numbers from them."""
    recorder, clock = rec
    recorder.full = False
    for i in range(2, 5):
        serve(recorder, clock, 100 + i, device_ms=3.0)
    spans = recorder.spans()
    assert {s.name for s in spans} == {"decide", "classify", "segment",
                                       "jit.replay", "plan_for", "account"}
    assert all(s.device_ms is None for s in spans)
    run = make_run()
    assert runtime_host_ms.read(run) == 4.0
    assert sched_self_ms.read(run) == 4.0


def test_each_reader_is_none_on_a_program_without_the_recorder(
        rec, monkeypatch):
    recorder, clock = rec
    serve(recorder, clock, 103, device_ms=3.0)
    import repro_torch.obs
    monkeypatch.delattr(repro_torch.obs, "runtime")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.runtime", None)
    run = make_run()
    for reader in READERS:
        assert reader.read(run) is None
