"""Lightweight span recorder shared by the simulator and the executors.

A *span* is one timed event on one resource of the ``2n+1``
compute/link pipeline (or its pooled generalization).  Both engines —
the arithmetic simulator in ``repro_torch.core.sim`` and the asyncio executor
in ``repro_torch.serving.async_engine`` — emit the *same* spans with the
*same* values, so the repo's differential-pin invariant extends to
traces: ``assert_traces_match(sim_trace, async_trace, tol=1e-6)``.

Span kinds (the closed vocabulary):

======================  ====================================================
``enqueue``             point: task entered a compute tier's input queue
``route``               point: pooled tier placed a task on a replica
``batch_form``          wait: a batch follower's input-ready -> batch start
``service``             busy: a compute interval (carries the batch)
``seq_hold``            wait: pool sequencer held a release to restore order
``xfer``                busy: a link transfer interval
``credit_wait``         wait: multi-tenant ingress arrival -> credit grant
``exit_release``        point: semantic exit freed all downstream resources
``replan``              point: task migrated to a new plan at a hop boundary
======================  ====================================================

Resources are tuples: ``("compute", k, r)`` for replica ``r`` of tier
``k`` (serial chains use ``r = 0``), ``("link", k)`` for hop ``k``'s
link; tier-level task events (``enqueue``, ``credit_wait``) use
``("compute", k)``.

The sink contract is *zero cost when disabled*: every emission site is
guarded by ``if sink is not None`` so the disabled path performs no
allocation and no call.  ``TraceRecorder`` is the default sink (an
append-only list); anything with a ``span(...)`` method works.  Hot
emitters (the executor's workers) pass *prefix tuples* of the Span
fields instead of constructed ``Span`` objects; ``TraceRecorder``
normalizes lazily — see its docstring.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

__all__ = [
    "ENQUEUE", "ROUTE", "BATCH_FORM", "SERVICE", "SEQ_HOLD", "XFER",
    "CREDIT_WAIT", "EXIT_RELEASE", "REPLAN", "SPAN_KINDS", "Span",
    "TraceRecorder", "spans_of", "canonical", "traces_match",
    "assert_traces_match", "resource_label", "tier_of", "is_link",
]

ENQUEUE = "enqueue"
ROUTE = "route"
BATCH_FORM = "batch_form"
SERVICE = "service"
SEQ_HOLD = "seq_hold"
XFER = "xfer"
CREDIT_WAIT = "credit_wait"
EXIT_RELEASE = "exit_release"
REPLAN = "replan"

SPAN_KINDS = (ENQUEUE, ROUTE, BATCH_FORM, SERVICE, SEQ_HOLD, XFER,
              CREDIT_WAIT, EXIT_RELEASE, REPLAN)

Resource = Tuple  # ("compute", k[, r]) | ("link", k)


class Span(NamedTuple):
    """One trace event.  ``t0 == t1`` for point events.

    ``task`` is the owning task (the batch head for ``service``);
    ``tasks`` the full batch membership; ``ready`` the head's
    input-ready instant (``tx_ready`` for ``xfer``); ``batch`` the
    realized batch size; ``hop`` the exit hop for ``exit_release`` (and
    the boundary a ``replan`` migration took effect at);
    ``replica``/``seq`` the routing decision for ``route``.
    """

    kind: str
    resource: Resource
    t0: float
    t1: float
    task: Optional[int] = None
    tasks: Optional[Tuple[int, ...]] = None
    ready: Optional[float] = None
    batch: Optional[int] = None
    hop: Optional[int] = None
    replica: Optional[int] = None
    seq: Optional[int] = None


class TraceRecorder:
    """Default ``TraceSink``: records spans, exposed as ``self.spans``.

    ``span`` accepts a full ``Span`` or a *prefix tuple* of its fields
    in declaration order (missing trailing fields default to ``None``).
    The prefix form is the executor's hot path: appending a plain tuple
    literal costs a fraction of a keyword ``Span(...)`` construction,
    which is what keeps enabled tracing inside the <5% overhead gate.
    Normalization to ``Span`` happens lazily (and is cached) when
    ``spans`` is first read.
    """

    __slots__ = ("_raw", "_spans")

    def __init__(self) -> None:
        self._raw: list = []
        self._spans: Optional[List[Span]] = None

    def span(self, s) -> None:
        self._raw.append(s)

    @property
    def spans(self) -> List[Span]:
        if self._spans is None or len(self._spans) != len(self._raw):
            self._spans = [s if type(s) is Span else Span(*s)
                           for s in self._raw]
        return self._spans

    def clear(self) -> None:
        self._raw.clear()
        self._spans = None

    def __len__(self) -> int:
        return len(self._raw)

    def __iter__(self):
        return iter(self.spans)


TraceLike = Union[TraceRecorder, Sequence[Span]]


def spans_of(trace: TraceLike) -> List[Span]:
    """Accept a ``TraceRecorder`` or a plain span sequence."""
    return list(getattr(trace, "spans", trace))


def tier_of(resource: Resource) -> int:
    return int(resource[1])


def is_link(resource: Resource) -> bool:
    return resource[0] == "link"


def resource_label(resource: Resource) -> str:
    """Stable human/JSON label: ``compute0/r1``, ``compute2``, ``link0``."""
    if resource[0] == "link":
        return f"link{resource[1]}"
    if len(resource) == 2:
        return f"compute{resource[1]}"
    return f"compute{resource[1]}/r{resource[2]}"


def _sort_key(s: Span):
    # Engines emit in different orders (the simulator replays stage by
    # stage, the executor interleaves in virtual time), so comparisons
    # sort canonically.  Discrete fields lead: float ties then cannot
    # reorder matched pairs across engines.
    return (s.kind, s.resource, -1 if s.task is None else s.task,
            -1 if s.seq is None else s.seq, s.t0, s.t1)


def canonical(trace: TraceLike) -> List[Span]:
    """Spans in the canonical (engine-independent) order."""
    return sorted(spans_of(trace), key=_sort_key)


def _span_diff(a: Span, b: Span, tol: float) -> Optional[str]:
    if (a.kind, a.resource, a.task, a.tasks, a.batch, a.hop, a.replica,
            a.seq) != (b.kind, b.resource, b.task, b.tasks, b.batch,
                       b.hop, b.replica, b.seq):
        return f"field mismatch: {a} != {b}"
    for name in ("t0", "t1", "ready"):
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None):
            return f"{name} presence mismatch: {a} != {b}"
        if x is not None and abs(x - y) > tol:
            return f"{name} off by {abs(x - y):.3e} (> {tol:g}): {a} != {b}"
    return None


def traces_match(a: TraceLike, b: TraceLike,
                 tol: float = 1e-6) -> Tuple[bool, str]:
    """Compare two traces after canonical sorting.

    Discrete fields must match exactly; instants (``t0``/``t1``/
    ``ready``) to ``tol``.  Returns ``(ok, first_difference)``.
    """
    ca, cb = canonical(a), canonical(b)
    if len(ca) != len(cb):
        return False, f"span count {len(ca)} != {len(cb)}"
    for sa, sb in zip(ca, cb):
        msg = _span_diff(sa, sb, tol)
        if msg is not None:
            return False, msg
    return True, ""


def assert_traces_match(a: TraceLike, b: TraceLike,
                        tol: float = 1e-6) -> None:
    ok, msg = traces_match(a, b, tol)
    assert ok, msg
