"""The port's wall-clock spans (``repro_torch.obs.runtime``) on the CPU: a
tiny ``CollabRuntime`` end + cloud step served through ``CoachEngine``'s
``decide`` / ``plan_for`` / ``account``, as ``launch/serve.py`` serves a
task.  Off, nothing is recorded; on (``enable()``, or a ``torch.profiler``
profile), the spans nest as the module's table says, carry the task's id
and lie inside their parents, and a ``segment`` span, taken to the
profiler's clock, holds the ``aten::`` events of its step.  The device
interval of a replay is a card's: ``tests/test_torch_gpu.py``."""

import gc
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import online as ON  # noqa: E402
from repro_torch.core.collab import CollabRuntime  # noqa: E402
from repro_torch.core.costs import (A6000_SERVER, JETSON_NX,  # noqa: E402
                                    WIFI_5GHZ, transformer_graph)
from repro_torch.core.partitioner import coach_offline  # noqa: E402
from repro_torch.data.pipeline import CorrelatedTaskStream  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.obs import export as EX  # noqa: E402
from repro_torch.obs import runtime as RT  # noqa: E402
from repro_torch.serving.engine import CoachEngine  # noqa: E402

N_LABELS = 8
SEQ = 8


@pytest.fixture(scope="module")
def served():
    """The engine, the runtime, ``serve(task)``, the task stream and the
    calibration set, on a reduced mamba2-130m cut after its first
    group."""
    cfg = get_config("mamba2-130m").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    rt = CollabRuntime(cfg, params, 1)
    link = WIFI_5GHZ(50.0)
    off = coach_offline(transformer_graph(cfg, batch=1, seq=128), JETSON_NX,
                        A6000_SERVER, link)
    stream = CorrelatedTaskStream(n_labels=N_LABELS, dim=cfg.d_model,
                                  correlation="medium", seed=0)

    def task_input(task):
        toks = (np.abs((task.features[:SEQ] * 1000).astype(np.int64))
                % cfg.vocab_size).astype(np.int32)
        return torch.as_tensor(toks)[None]

    calib = stream.tasks(40)
    with torch.no_grad():
        h = rt._seg_fns[0](rt.p_end, torch.cat([task_input(t)
                                                for t in calib]))
    feats = (torch.sum(h, dim=1) / h.shape[1]).numpy()
    engine = CoachEngine(rt, off.times, JETSON_NX, link, A6000_SERVER,
                         n_labels=N_LABELS, calib_feats=feats,
                         calib_labels=np.asarray([t.label for t in calib]),
                         boundary_elems=128 * cfg.d_model)
    acc = {"exits": 0, "wire": 0.0, "bits": [], "correct": []}

    def classify(task):
        centers, valid = engine.sched.probe_centers()
        pkt, probe = rt.end_step_fused(task_input(task),
                                       torch.as_tensor(centers))
        logits = rt.cloud_step(pkt)
        pr = ON.ProbeResult.from_fused(
            probe.sims[0].numpy(), probe.sep[0].numpy(),
            probe.best[0].numpy(), valid, n_labels=N_LABELS)
        return (probe.feat[0].numpy(),
                int(np.argmax(logits[0].numpy()) % N_LABELS), pr)

    def serve(task):
        with torch.no_grad():
            dec, feats, pred = engine.decide(task, 50e6, classify)
            _, wire_bits = engine.plan_for(dec, 50e6)
            engine.account(dec, feats, pred, task, wire_bits, acc)

    serve(stream.tasks(1)[0])  # lazy set-up out of the way
    return types.SimpleNamespace(
        engine=engine, rt=rt, serve=serve, task_input=task_input,
        stream=stream, calib=(feats, np.asarray([t.label for t in calib])),
        off=off, link=link)


@pytest.fixture(autouse=True)
def quiet_recorder():
    RT.disable()
    RT.RECORDER.clear()
    yield
    RT.disable()
    RT.RECORDER.spans()  # takes the collection hook out
    RT.RECORDER.clear()


def _on(how):
    """A context in which the recorder records: ``enable()`` or a CPU
    profile."""
    import contextlib
    if how == "profiler":
        return torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])

    @contextlib.contextmanager
    def enabled():
        RT.enable()
        try:
            yield
        finally:
            RT.disable()
    return enabled()


def test_off_the_ring_stays_empty(served):
    serve, stream = served.serve, served.stream
    for t in stream.tasks(2):
        serve(t)
    gc.collect()
    assert len(RT.RECORDER) == 0 and RT.RECORDER.spans() == []
    assert RT.recording() is None
    assert RT.RECORDER._gc not in gc.callbacks


# (name, the parent's name, or None for a span with no parent); under a
# profile without ``enable()`` only the spans in ``RT.PROFILED``, a
# ``jit.replay`` then the child of its ``segment``
TABLE = [("decide", None), ("classify", "decide"), ("segment", "classify"),
         ("boundary", "segment"), ("dequantize", "segment"),
         ("jit", "segment"), ("jit.key", "jit"), ("jit.replay", "jit"),
         ("jit.copy_in", "jit"), ("jit.clone_out", "jit"),
         ("plan_for", None), ("account", None)]
A_TASK = ["decide", "classify", "segment", "segment", "boundary",
          "dequantize", "jit", "jit", "jit.key", "jit.key", "jit.replay",
          "jit.replay", "plan_for", "account"]


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_spans_nest_as_in_the_table_and_carry_the_task(served, how):
    serve, stream = served.serve, served.stream
    tasks = stream.tasks(3)
    with _on(how):
        assert RT.recording() is RT.RECORDER
        assert RT.RECORDER.full == (how == "enable")
        for t in tasks:
            serve(t)
    full = how == "enable"
    table = dict(TABLE) if full else dict(
        TABLE, **{"jit.replay": "segment"})
    spans = RT.RECORDER.spans()
    by_id = {s.id: s for s in spans}
    for t in tasks:
        mine = [s for s in spans if s.task == t.id and s.name != "gc"]
        names = sorted(s.name for s in mine)
        assert names == sorted(n for n in A_TASK
                               if full or n in RT.PROFILED), names
        assert sorted(s.arg for s in mine if s.name == "segment") == [0, 1]
        for s in mine:
            parent = table[s.name]
            if parent is None:
                assert s.parent is None, s
                continue
            p = by_id[s.parent]
            assert p.name == parent and p.task == t.id, (s, p)
            assert p.t0 <= s.t0 <= s.t1 <= p.t1, (s, p)
        if full:  # K1 on the end's segment, K2 on the cloud's
            seg = {by_id[s.parent].arg: s.name for s in mine
                   if s.name in ("boundary", "dequantize")}
            assert seg == {0: "boundary", 1: "dequantize"}
        assert all(s.device_ms is None for s in mine)  # CPU replays
    # a task's spans follow one another: decide, then plan_for, account
    first = {s.name: s for s in spans if s.task == tasks[0].id}
    assert first["decide"].t1 <= first["plan_for"].t0 \
        <= first["plan_for"].t1 <= first["account"].t0
    assert [s for s in spans if s.task is None and s.name != "gc"] == []


def test_spans_made_outside_a_task_carry_none(served):
    rt, task_input = served.rt, served.task_input
    serve, stream = served.serve, served.stream
    serve(stream.tasks(1)[0])  # off: sets no id
    RT.enable()
    with torch.no_grad():
        rt.cloud_step(rt.end_step(task_input(stream.tasks(1)[0]))[0])
    RT.disable()
    spans = RT.RECORDER.spans()
    assert {s.name for s in spans} >= {"segment", "jit", "quantize",
                                       "dequantize"}
    assert all(s.task is None for s in spans)


def test_the_async_engines_tasks_keep_their_own_ids(served):
    """The async engine decides on its end worker, an asyncio task of its
    own: each task's spans carry that task's id, and the id set there
    does not leak into the caller's context."""
    from repro_torch.serving.async_engine import AsyncCoachEngine
    rt, task_input, stream = served.rt, served.task_input, served.stream
    feats, labels = served.calib
    eng = AsyncCoachEngine(rt, served.off.times, JETSON_NX, served.link,
                           A6000_SERVER, n_labels=N_LABELS,
                           calib_feats=feats, calib_labels=labels,
                           boundary_elems=served.engine.sched.elems)

    def classify(task):
        centers, valid = eng.sched.probe_centers()
        pkt, probe = rt.end_step_fused(task_input(task),
                                       torch.as_tensor(centers))
        rt.cloud_step(pkt)
        pr = ON.ProbeResult.from_fused(
            probe.sims[0].numpy(), probe.sep[0].numpy(),
            probe.best[0].numpy(), valid, n_labels=N_LABELS)
        return probe.feat[0].numpy(), 0, pr

    tasks = stream.tasks(4)
    with torch.no_grad(), _on("enable"):
        eng.run_stream(tasks, arrival_period=1e-3, classify=classify)
        assert RT._TASK.get() is None
    spans = RT.RECORDER.spans()
    by_id = {s.id: s for s in spans}
    for t in tasks:
        dec, = [s for s in spans if s.name == "decide" and s.task == t.id]
        segs = [s for s in spans if s.name == "segment"
                and by_id[by_id[s.parent].parent] is dec]
        assert len(segs) == 2 and all(s.task == t.id for s in segs)
        assert [s.name for s in spans if s.task == t.id
                and s.parent is None] == ["decide", "plan_for", "account"]


def test_recording_stops_when_the_profile_ends(served):
    serve, stream = served.serve, served.stream
    with _on("profiler"):
        serve(stream.tasks(1)[0])
    n = len(RT.RECORDER)
    assert n >= 8 and RT.recording() is None
    serve(stream.tasks(1)[0])
    gc.collect()
    assert len(RT.RECORDER) == n
    RT.RECORDER.spans()
    assert RT.RECORDER._gc not in gc.callbacks


def test_a_collection_while_recording_is_a_gc_span(served):
    serve, stream = served.serve, served.stream
    task = stream.tasks(1)[0]
    RT.enable()
    assert RT.RECORDER._gc not in gc.callbacks  # none recorded yet
    serve(task)
    assert RT.RECORDER._gc in gc.callbacks
    gc.collect()
    RT.disable()
    assert RT.RECORDER._gc not in gc.callbacks
    gcs = [s for s in RT.RECORDER.spans() if s.name == "gc"]
    assert gcs and gcs[-1].arg == 2 and gcs[-1].parent is None
    assert gcs[-1].t1 >= gcs[-1].t0


def test_the_ring_drops_the_oldest_and_counts_them():
    rec = RT.Recorder(capacity=4)
    for i in range(10):
        rec.close(rec.open(f"s{i}"))
    rec._unhook()
    spans = rec.spans()
    assert [s.name for s in spans] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped == 6 and len(rec) == 4
    rec.clear()
    assert len(rec) == 0 and rec.dropped == 0


def test_a_span_whose_body_raises_is_kept_and_nests():
    rec = RT.Recorder()
    outer = rec.open("outer")
    with pytest.raises(ZeroDivisionError):
        rec.call("inner", lambda: 1 / 0)
    rec.close(outer)
    rec.close(rec.open("after"))
    rec._unhook()
    spans = {s.name: s for s in rec.spans()}
    assert spans["inner"].parent == spans["outer"].id
    assert spans["after"].parent is None and rec._depth == 0


def test_a_segment_span_holds_its_steps_aten_events(served):
    """Taken to the profiler's clock (Unix-epoch ns), the ``segment``
    span of the end's step contains every ``aten::`` event that the CPU
    profile recorded for that step."""
    engine, rt = served.engine, served.rt
    task_input, stream = served.task_input, served.stream
    inp = task_input(stream.tasks(1)[0])
    centers = torch.as_tensor(engine.sched.probe_centers()[0])
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rt.end_step_fused(inp, centers)
    seg, = [s for s in RT.RECORDER.spans() if s.name == "segment"]
    a, b = (t + RT.RECORDER.offset_ns for t in (seg.t0, seg.t1))
    aten = [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("aten::")]
    assert len(aten) > 20
    slack = 20_000  # ns: the two clocks' reads of one instant
    assert all(a - slack <= s and t <= b + slack for s, t in aten), \
        (a, b, min(aten), max(aten))
    # and they fill it: the step is mostly aten work
    assert min(s for s, _ in aten) - a < (b - a) / 2


def test_export_writes_the_spans_on_the_epoch_clock(served, tmp_path):
    serve, stream = served.serve, served.stream
    task = stream.tasks(1)[0]
    with _on("enable"):
        serve(task)
    spans = RT.RECORDER.spans()
    off = RT.RECORDER.offset_ns
    doc = EX.write_runtime_trace(tmp_path / "rt.json", spans, off)
    assert json.load(open(tmp_path / "rt.json")) == doc
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(spans)
    dec, = [e for e in xs if e["name"] == "decide"]
    s, = [s for s in spans if s.name == "decide"]
    assert dec["ts"] == (s.t0 + off) / 1e3
    assert dec["dur"] == (s.t1 - s.t0) / 1e3
    assert dec["args"]["task"] == task.id


def test_per_task_sums_a_tasks_spans(served):
    serve, stream = served.serve, served.stream
    tasks = stream.tasks(2)
    with _on("enable"):
        for t in tasks:
            serve(t)
    spans = RT.RECORDER.spans()
    got = RT.per_task(spans, [tasks[1].id], ["segment"])
    want = sum(s.t1 - s.t0 for s in spans
               if s.name == "segment" and s.task == tasks[1].id)
    assert got == {tasks[1].id: want} and want > 0
    assert RT.per_task(spans, [tasks[0].id], ["jit.replay"],
                       value=lambda s: s.device_ms) == {}
    own = RT.per_task(spans, [tasks[0].id], ["decide"], less=["classify"])
    dec, cls = ([s for s in spans if s.task == tasks[0].id and s.name == n]
                for n in ("decide", "classify"))
    assert own == {tasks[0].id: RT.host_ns(dec[0]) - RT.host_ns(cls[0])} and 0 < own[
        tasks[0].id] < RT.host_ns(dec[0])
    segs = [RT.per_task(spans, [t.id], ["segment"])[t.id] for t in tasks]
    assert RT.median_ms(spans, [t.id for t in tasks], ["segment"]) == \
        (segs[0] + segs[1]) / 2 / 1e6
    assert RT.median_ms(spans, [t.id for t in tasks], ["jit.replay"],
                        value=RT.device_ns) is None


def test_serve_writes_its_spans_and_prints_them_beside_the_modelled(
        tmp_path, capsys):
    from repro_torch.launch.serve import serve
    path = tmp_path / "spans.json"
    serve("mamba2-130m", requests=4, device="cpu", trace_path=str(path))
    out = capsys.readouterr().out.splitlines()
    assert "modelled from the cost profiles, not measured" in out[2]
    assert out[3].startswith("measured (wall-clock spans, median a task): "
                             "scheduler ") and "graph device -" in out[3]
    assert RT.recording() is None
    xs = [e for e in json.load(open(path))["traceEvents"] if e["ph"] == "X"]
    decides = [e for e in xs if e["name"] == "decide"]
    assert len(decides) == 4
    assert sorted(e["args"]["task"] for e in decides) == \
        sorted({e["args"]["task"] for e in decides})
    assert {e["name"] for e in xs} >= {"classify", "segment", "jit",
                                       "jit.replay", "plan_for", "account"}
