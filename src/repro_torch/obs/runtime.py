"""Wall-clock spans of the port's runtime: where a served task's host time
goes, and the device time of each CUDA graph replay.

``obs.trace`` records *modelled* time (the cost profiles through
``core.sim``); this module records the program's own clock.  A span holds
its name, its start and end in host ns (``time.perf_counter_ns``, a
monotonic clock), its id, its parent's id, the id of the task it serves,
one argument and, for a ``jit.replay`` on CUDA arguments, the replay's
device interval.  The spans of the served path are made on one thread and
nest, so a span's parent is the innermost span that holds it, found when
the spans are read.

==============  ======================  ==================================
layer           site                    spans (children indented by ``>``)
==============  ======================  ==================================
scheduler       ``serving/base.py``     ``decide`` > ``classify`` (the
                                        caller's callback); ``plan_for``;
                                        ``account``
runtime         ``core/collab.py``      ``segment`` (argument ``k``) >
                                        ``dequantize`` (K2), ``boundary``
                                        (K1), ``quantize`` (K3)
runtime         ``core/jit.py``         ``jit`` > ``jit.key``,
                                        ``jit.capture``, ``jit.copy_in``,
                                        ``jit.replay``, ``jit.clone_out``
host            ``gc.callbacks``        ``gc`` (argument: the generation)
==============  ======================  ==================================

On CPU arguments ``jit`` calls its function where a graph would replay,
under the same ``jit.replay`` name, with no device interval.

**When it records.**  From ``enable()`` to ``disable()``: every span of
the table, and each replay's device interval.  While a ``torch.profiler``
profile records and ``enable()`` was not called: only the spans in
``PROFILED``, those a benchmark metric reads, and no device interval (the
profile has the device's own trace, and under it the events' interval
grows with the profiler's slowing of the graph launch).  Off, each site
makes one test (``recording()``): no clock read, no allocation, no CUDA
call.  Nothing here calls the profiler: its trace holds none of these
spans.

**Task ids.**  ``decide`` sets the id from ``task.id`` in a
``contextvars`` variable, so that the async engine's interleaved tasks
keep their own; ``plan_for`` and ``account`` carry it, and ``account``,
the last of a task's scheduler calls, clears it.  Spans made outside a
task (calibration, warm-up) carry none.

**Where spans are kept.**  In ``RECORDER``, a ring of ``CAPACITY``
entries that drops its oldest and counts them (``dropped``).  Nothing is
written out on the hot path; counts come from the spans (replays a task
is the number of its ``jit.replay`` spans).

**Device intervals.**  Two CUDA events from a reused pool, recorded on
the current stream right before and right after ``graph.replay()``.  They
are read when the spans are read, which waits for those not yet done, so
reading them adds nothing to the served path; only once ``READ_AT``
replays wait are the done ones read at the close of a span with no parent
(no span is open then, so no ``jit`` capture is under way).

**Clocks.**  ``torch.profiler`` (Kineto) stamps its events in Unix-epoch
ns, the clock of ``time.time_ns()``; a span's stamp plus the recorder's
``offset_ns`` is on that clock, so an idle gap in a profile can be put
down to the span the host was in.

**Collections.**  While recording, each cyclic garbage collection is a
``gc`` span, from a ``gc.callbacks`` hook that the first span recorded
puts in and that ``disable()``, or the first read of the spans after
recording ended, takes out; in between, a collection costs the hook one
test.
"""

from __future__ import annotations

import collections
import contextvars
import functools
import gc
import statistics
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["Span", "Recorder", "RECORDER", "CAPACITY", "PROFILED",
           "recording", "enable", "disable", "decide_span", "plan_span",
           "account_span", "host_ns", "device_ns", "per_task", "median_ms"]

CAPACITY = 1 << 16
READ_AT = 4096  # replays waiting before the done ones are read in the path
# the spans recorded under a profile without ``enable()``
PROFILED = frozenset({"decide", "classify", "plan_for", "account",
                      "segment", "jit.replay", "gc"})

_now = time.perf_counter_ns
_TASK: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_runtime_task", default=None)


class Span(NamedTuple):
    """One wall-clock span; ``t0`` / ``t1`` in ``perf_counter_ns``."""

    name: str
    t0: int
    t1: int
    id: int
    parent: Optional[int]
    task: Optional[int]
    arg: object = None                 # a segment's k, a gc generation
    device_ms: Optional[float] = None  # a CUDA graph replay's interval


def host_ns(span: Span) -> int:
    return span.t1 - span.t0


def device_ns(span: Span) -> Optional[float]:
    """A replay's device interval in ns; None off the card."""
    return None if span.device_ms is None else span.device_ms * 1e6


def _epoch_offset_ns() -> int:
    """``time.time_ns() - perf_counter_ns()``, from the tightest of a
    few bracketed reads."""
    best = None
    for _ in range(8):
        a = _now()
        e = time.time_ns()
        b = _now()
        if best is None or b - a < best[0]:
            best = (b - a, e - (a + b) // 2)
    return best[1]


class Recorder:
    """The ring of spans.

    Entries are plain tuples ``(name, t0, t1, task, arg)``, one made as a
    span closes; a replay's ``arg`` is a one-slot list that its device
    interval fills in later.  Ids and parents are given when the spans are
    read (``spans()``), not while they are recorded.

    ``full``: record every span and the device intervals; else only the
    names in ``PROFILED``, and no interval.  ``open`` returns None for a
    span it does not record, which ``close`` takes too."""

    def __init__(self, capacity: int = CAPACITY, full: bool = True):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.full = full
        self._depth = 0                # spans open
        self._steps: list = []         # [span, its current step] a begin
        self._pending: collections.deque = collections.deque()
        self._events: list = []        # event pairs free for reuse
        self._streams: dict = {}       # raw stream -> its torch Stream
        self._gc_op = None
        self._hooked = False
        self.offset_ns = _epoch_offset_ns()

    # ------------------------------------------------------------ recording
    def open(self, name: str, arg=None) -> Optional[tuple]:
        """Start a span; ``close`` takes what this returns."""
        if not self.full and name not in PROFILED:
            return None
        if not self._hooked:
            self._hook()
        self._depth += 1
        return name, _now(), arg

    def close(self, op: Optional[tuple], poll: bool = True) -> None:
        if op is None:
            return
        t1 = _now()
        self._depth -= 1
        ring = self._ring
        if len(ring) == ring.maxlen:
            self.dropped += 1
        ring.append((op[0], op[1], t1, _TASK.get(), op[2]))
        if poll and not self._depth and len(self._pending) >= READ_AT:
            self._poll(wait=False)

    def begin(self, name: str, arg=None) -> None:
        """Open a span whose phases ``step`` marks; ``end`` closes it.
        Each ``begin`` is closed by its own ``end``, innermost first."""
        self._steps.append([self.open(name, arg), None])

    def step(self, name: Optional[str], arg=None) -> None:
        """End the innermost ``begin``'s current phase, if any, and start
        a child span ``name`` (none for None)."""
        top = self._steps[-1]
        self.close(top[1])
        top[1] = None if name is None else self.open(name, arg)

    def end(self) -> None:
        span, phase = self._steps.pop()
        self.close(phase)
        self.close(span)

    def call(self, name: str, fn, *args):
        """``fn(*args)`` under a span named ``name``."""
        self.begin(name)
        try:
            return fn(*args)
        finally:
            self.end()

    def replay(self, graph) -> None:
        """``graph.replay()`` as the ``jit.replay`` step, with its device
        interval between two events on the current stream when ``full``."""
        if not self.full:
            self.step("jit.replay")
            graph.replay()
            return
        box = [None]
        self.step("jit.replay", box)
        start, end = self._events.pop() if self._events else (
            torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
        stream = self._current_stream()
        start.record(stream)
        graph.replay()
        end.record(stream)
        self._pending.append((box, start, end))

    def _current_stream(self):
        """``torch.cuda.current_stream()``, which makes a Stream object a
        call (5 us on an H100's host): one is kept a raw stream."""
        raw = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        stream = self._streams.get(raw)
        if stream is None:
            stream = self._streams[raw] = torch.cuda.current_stream()
        return stream

    def _poll(self, wait: bool) -> None:
        """Read the device intervals whose events have completed, in
        order (all of them, waiting, with ``wait``).  Called when no span
        is open, so never inside a ``jit`` capture."""
        pending = self._pending
        while pending:
            box, start, end = pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            box[0] = start.elapsed_time(end)
            pending.popleft()
            self._events.append((start, end))

    # ----------------------------------------------------------- collections
    def _hook(self) -> None:
        self._hooked = True
        gc.callbacks.append(self._gc)

    def _unhook(self) -> None:
        if self._hooked:
            self._hooked = False
            gc.callbacks.remove(self._gc)

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            if recording() is not None:
                self._gc_op = self.open("gc", info["generation"])
        elif self._gc_op is not None:
            op, self._gc_op = self._gc_op, None
            self.close(op, poll=False)

    # -------------------------------------------------------------- reading
    def spans(self) -> List[Span]:
        """The ring's spans in the order they started, each with an id
        (its place in this list, from 1), its parent's id (the innermost
        span that holds it) and a replay's device interval (read now,
        waiting for those not yet done)."""
        if self._pending:
            self._poll(wait=True)
        if recording() is None:
            self._unhook()
        # by start, and of two that start together the longer first
        raw = sorted(self._ring, key=lambda s: (s[1], -s[2]))
        out: List[Span] = []
        holding: List[Span] = []       # the spans that hold this one
        for i, (name, t0, t1, task, arg) in enumerate(raw, 1):
            while holding and holding[-1].t1 < t1:
                holding.pop()
            box = type(arg) is list
            s = Span(name, t0, t1, i, holding[-1].id if holding else None,
                     task, None if box else arg, arg[0] if box else None)
            out.append(s)
            holding.append(s)
        return out

    def clear(self) -> None:
        self._ring.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._ring)


RECORDER = Recorder(full=False)
_enabled = False


def recording() -> Optional[Recorder]:
    """``RECORDER`` while it records, else None: the one test a site
    makes."""
    return RECORDER if _enabled or _profiler._is_profiler_enabled else None


def enable() -> Recorder:
    global _enabled
    _enabled = RECORDER.full = True
    return RECORDER


def disable() -> None:
    global _enabled
    _enabled = RECORDER.full = False
    if not _profiler._is_profiler_enabled:
        RECORDER._unhook()


# ------------------------------------------------------ scheduler decorators
# Each keeps its method's own signature: off, a wrapper that forwards
# ``*args`` costs three times as much.
def decide_span(fn):
    """``EngineBase.decide`` under a ``decide`` span, the task's id set
    from ``task.id``, and the caller's ``classify`` under a ``classify``
    child span."""

    @functools.wraps(fn)
    def decide(self, task, bw, classify):
        rec = recording()
        if rec is None:
            return fn(self, task, bw, classify)
        _TASK.set(task.id)
        op = rec.open("decide")
        try:
            return fn(self, task, bw,
                      functools.partial(rec.call, "classify", classify))
        finally:
            rec.close(op)

    return decide


def plan_span(fn):
    """``EngineBase.plan_for`` under a ``plan_for`` span."""

    @functools.wraps(fn)
    def plan_for(self, dec, bw, hop_bits=None):
        rec = recording()
        if rec is None:
            return fn(self, dec, bw, hop_bits)
        op = rec.open("plan_for")
        try:
            return fn(self, dec, bw, hop_bits)
        finally:
            rec.close(op)

    return plan_for


def account_span(fn):
    """``EngineBase.account`` under an ``account`` span; the task's id
    is cleared after it, the last of the task's scheduler calls."""

    @functools.wraps(fn)
    def account(self, dec, feats, pred, task, wire_bits, acc):
        rec = recording()
        if rec is None:
            return fn(self, dec, feats, pred, task, wire_bits, acc)
        op = rec.open("account")
        try:
            return fn(self, dec, feats, pred, task, wire_bits, acc)
        finally:
            rec.close(op)
            _TASK.set(None)

    return account


# ----------------------------------------------------------------- queries
def per_task(spans: Iterable[Span], tasks, names, less=(),
             value=host_ns) -> Dict[int, float]:
    """{task: the sum of ``value(span)`` over its spans named in
    ``names``, less that over its spans named in ``less``} for each task
    of ``tasks`` with a span in ``names`` that has a value (``value`` is a
    span's host ns by default; a ``decide``'s self time is ``names =
    ("decide",)``, ``less = ("classify",)``)."""
    tasks, names, less = set(tasks), set(names), set(less)
    out: Dict[int, float] = {}
    sub: Dict[int, float] = {}
    for s in spans:
        if s.task in tasks and (s.name in names or s.name in less):
            v = value(s)
            if v is not None:
                into = out if s.name in names else sub
                into[s.task] = into.get(s.task, 0) + v
    return {t: v - sub.get(t, 0) for t, v in out.items()}


def median_ms(spans: Iterable[Span], tasks, names, less=(),
              value=host_ns) -> Optional[float]:
    """The median over ``tasks`` of ``per_task``, in ms; None when no
    task has a span."""
    per = per_task(spans, tasks, names, less, value)
    return statistics.median(per.values()) / 1e6 if per else None
