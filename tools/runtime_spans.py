#!/usr/bin/env python3
"""The port's wall-clock spans (``repro_torch.obs.runtime``) on a
benchmark cell: where a served task's host time goes, the device time of
its graph replays, what recording costs, and whether the spans share the
profiler's clock.

  python3 tools/runtime_spans.py cost [--repeat 5]
  python3 tools/runtime_spans.py split --workload CELL --seed N \\
      [--seconds 8] [--windows off,on,on,off] [--out DIR]
  python3 tools/runtime_spans.py interleave --workload CELL --seed N \\
      [--tasks 2000]
  python3 tools/runtime_spans.py clock --workload CELL --seed N \\
      [--tasks 32] [--out DIR]

``cost`` times, on this host's CPU, the code that the instrumented sites
run with the recorder off (the scheduler's three decorators against the
bare method, ``recording()``, the ``None`` tests of the inline sites) and
adds them up for one served task's sites: ns a task; on a card, also the
us a call of a span and of the CUDA event calls a recorded replay makes.

``split`` sets a cell up as ``perfbench/run.py`` does (its driver, the
same weights and tasks from ``--seed``) and serves closed-loop windows of
``--seconds`` one after another, each with the recorder off or on
(``enable()``, no profiler): per window the median service ms (start to
answer) and, on, the medians a task of its spans: the graphs' device ms
(``jit.replay`` intervals), the host ms in ``segment``, ``jit`` and each
``jit.*`` phase, ``decide`` less ``classify``, ``classify`` less its
segments (the copies to the host), ``plan_for`` + ``account``, and
collections.

``interleave`` serves ``--tasks`` tasks with the recorder on for every
other one: the difference of the two halves' median service times is the
recorder's cost a task, free of the slow drifts between windows.

``clock`` profiles ``--tasks`` tasks under ``torch.profiler`` (the
recorder records while it does) and reports the share of ``jit.replay``
spans that, taken to the profiler's clock, contain a ``cudaGraphLaunch``
runtime event, the offset between the clocks, and the profile's idle
device gaps summed by the innermost program span the host was in.

``split`` and ``clock`` need a CUDA device; each prints the card's name
and power limit and one JSON object a window, also written under
``--out`` (default ``runtime_spans_out/``, which git ignores).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import statistics
import subprocess
import sys
import time
import timeit

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

SITES = """one served task: decide, plan_for and account (decorators); two
segment_step calls (recording(), 3 tests for the end's, 4 for the cloud's);
two jit calls (recording(), 5 tests each)"""


def cost(repeat: int) -> dict:
    """ns a served task that the sites cost with the recorder off."""
    from repro_torch.obs import runtime as RT
    assert RT.recording() is None

    def best(stmt, env, number=200_000):
        return min(timeit.repeat(stmt, globals=env, number=number,
                                 repeat=repeat)) / number * 1e9

    class Engine:
        def decide(self, task, bw, classify):
            return None

        def plan_for(self, dec, bw, hop_bits=None):
            return None

        def account(self, dec, feats, pred, task, wire_bits, acc):
            return None

    bare = Engine()
    traced = type("Traced", (Engine,), {
        "decide": RT.decide_span(Engine.decide),
        "plan_for": RT.plan_span(Engine.plan_for),
        "account": RT.account_span(Engine.account)})()
    env = {"bare": bare, "traced": traced, "RT": RT, "rec": None}
    ns = {}
    for name, args in (("decide", "1, 2, 3"), ("plan_for", "1, 2"),
                       ("account", "1, 2, 3, 4, 5, 6")):
        ns[name] = best(f"traced.{name}({args})", env) - best(
            f"bare.{name}({args})", env)
    ns["recording"] = best("RT.recording()", env)
    ns["test"] = best("1 if rec is None else 2", env) - best("1", env)
    total = (ns["decide"] + ns["plan_for"] + ns["account"]
             + 4 * ns["recording"] + (3 + 4 + 2 * 5) * ns["test"])
    return {"mode": "cost", "ns_a_site": ns, "ns_a_task": total,
            "sites": " ".join(SITES.split()), "python": sys.version.split()[0]}


# ------------------------------------------------------------------ the card
def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def set_up(cell: str, seed: int):
    import gc

    import torch

    from perfbench.harness.main import load
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _, _, conf, traffic, limits = load(ROOT, cell)
    mod = __import__(f"perfbench.drivers.{limits['driver']}",
                     fromlist=["Driver"])
    drv = mod.Driver(conf, traffic, seed, dev, traced=False)
    gc.collect()
    gc.freeze()
    return drv


def task_medians(spans, tasks) -> dict:
    """Medians a task, ms, of the spans' sums (each over the tasks that
    have one)."""
    from repro_torch.obs import runtime as RT

    def med(names, less=(), value=RT.host_ns):
        return RT.median_ms(spans, tasks, names, less, value)

    out = {"graph_device_ms": med(("jit.replay",), value=RT.device_ns),
           "segment_ms": med(("segment",)), "jit_ms": med(("jit",)),
           "runtime_host_ms": med(("segment",), ("jit.replay",))}
    for name in ("jit.key", "jit.copy_in", "jit.replay", "jit.clone_out",
                 "dequantize", "boundary", "plan_for", "account"):
        out[f"{name}_ms"] = med((name,))
    out["decide_self_ms"] = med(("decide",), ("classify",))
    out["classify_outside_segments_ms"] = med(("classify",), ("segment",))
    out["sched_self_ms"] = med(("decide", "plan_for", "account"),
                               ("classify",))
    gcs = RT.per_task(spans, tasks, ("gc",))
    out["gc_ms_a_task"] = sum(gcs.values()) / 1e6 / len(tasks)
    out["gc_a_task"] = sum(1 for s in spans if s.name == "gc"
                           and s.task in set(tasks)) / len(tasks)
    out["replays_a_task"] = med(("jit.replay",), value=lambda s: 1e6)
    return out


def split(args) -> list:
    from perfbench.harness import window as WIN
    from repro_torch.obs import runtime as RT
    drv = set_up(args.workload, args.seed)
    rows = []
    for w, mode in enumerate(args.windows.split(",")):
        on = mode == "on"
        if on:
            RT.enable().clear()
        try:
            res = WIN.run(drv, args.seed + w, args.seconds, None, False)
        finally:
            RT.disable()
        recs = [r for r in res["records"] if r.ok]
        row = {"mode": "split", "cell": args.workload, "seed": args.seed,
               "window": w, "recorder": mode, "tasks": len(recs),
               "failures": len(res["failures"]),
               "service_ms": 1e3 * statistics.median(
                   r.end - r.start for r in recs)}
        if hasattr(recs[0], "sched_s"):  # the harness's own timestamps
            row["sched_host_ms"] = 1e3 * statistics.median(
                r.sched_s for r in recs)
        if on:
            spans = RT.RECORDER.spans()
            row.update(task_medians(spans, [r.task.id for r in recs]))
            row["spans"], row["dropped"] = len(spans), RT.RECORDER.dropped
            RT.RECORDER.clear()
        rows.append(row)
    off = [r["service_ms"] for r in rows if r["recorder"] == "off"]
    on = [r["service_ms"] for r in rows if r["recorder"] == "on"]
    if off and on:
        rows.append({"mode": "split", "cell": args.workload,
                     "seed": args.seed, "on_over_off":
                     statistics.median(on) / statistics.median(off),
                     "on_minus_off_us": 1e3 * (statistics.median(on)
                                               - statistics.median(off))})
    return rows


def interleave(args) -> list:
    """The recorder on for every other task (``enable()``, no profiler):
    adjacent tasks share the card's state, so the difference of the two
    halves' median service times is what recording costs a task."""
    from repro_torch.obs import runtime as RT
    drv = set_up(args.workload, args.seed)
    service = {True: [], False: []}
    sched = {True: [], False: []}
    poll_ns = [0]
    poll = RT.RECORDER._poll

    def timed_poll(wait):  # what reading the device intervals costs
        t = time.perf_counter_ns()
        poll(wait)
        poll_ns[0] += time.perf_counter_ns() - t

    RT.RECORDER._poll = timed_poll
    for i, task in enumerate(drv.draw(args.tasks)):
        on = bool(i % 2)
        rec = drv.record(i, task, time.perf_counter())
        if on:
            RT.enable()
        rec.start = time.perf_counter()
        drv.serve(rec, False)
        RT.disable()
        service[on].append(rec.end - rec.start)
        sched[on].append(getattr(rec, "sched_s", 0.0))
        if len(RT.RECORDER) > RT.CAPACITY // 2:
            RT.RECORDER.clear()
    on, off = (1e3 * statistics.median(service[k][8:]) for k in (True,
                                                                False))
    mean = {k: 1e3 * statistics.fmean(service[k][8:]) for k in service}
    return [{"mode": "interleave", "cell": args.workload, "seed": args.seed,
             "tasks": args.tasks, "service_ms_on": on, "service_ms_off": off,
             "on_minus_off_us": 1e3 * (on - off), "on_over_off": on / off,
             "mean_on_minus_off_us": 1e3 * (mean[True] - mean[False]),
             "poll_us_a_recorded_task": poll_ns[0] / 1e3 / len(service[True]),
             "sched_host_us_on_minus_off": 1e6 * (
                 statistics.median(sched[True][8:])
                 - statistics.median(sched[False][8:]))}]


def card_calls(repeat: int) -> dict:
    """us a call of what recording a replay costs on the card: a span
    opened and closed, an event record, query and elapsed time."""
    import torch

    from repro_torch.obs import runtime as RT
    rec = RT.Recorder()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    stream = torch.cuda.current_stream()
    start.record(stream)
    end.record(stream)
    torch.cuda.synchronize()
    env = {"rec": rec, "start": start, "end": end, "stream": stream,
           "torch": torch}
    out = {}
    for name, stmt in (("span", "rec.close(rec.open('x'))"),
                       ("event_record", "end.record(stream)"),
                       ("event_query", "end.query()"),
                       ("elapsed_time", "start.elapsed_time(end)"),
                       ("current_stream", "torch.cuda.current_stream()")):
        out[name] = min(timeit.repeat(stmt, globals=env, number=20_000,
                                      repeat=repeat)) / 20_000 * 1e6
        rec.clear()
    torch.cuda.synchronize()
    rec._unhook()
    return out


def clock(args) -> list:
    import torch
    from torch.autograd import DeviceType

    from perfbench.harness import window as WIN
    from repro_torch.obs import runtime as RT
    drv = set_up(args.workload, args.seed)
    WIN.warm_profiler(drv)
    RT.RECORDER.clear()
    recs = [drv.record(i, t, time.perf_counter())
            for i, t in enumerate(drv.draw(args.tasks + 8))]
    for r in recs[:8]:  # steady before the profile
        drv.serve(r, False)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    for r in recs[8:]:
        r.start = time.perf_counter()
        drv.serve(r, False)
    torch.cuda.synchronize()
    prof.stop()
    off_ns = RT.RECORDER.offset_ns
    tasks = {r.task.id for r in recs[8:]}
    spans = [s for s in RT.RECORDER.spans() if s.task in tasks]
    events = list(prof.profiler.kineto_results.events())
    launches = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in events
                      if e.name().startswith("cudaGraphLaunch")
                      and e.device_type() != DeviceType.CUDA)
    starts = [a for a, _ in launches]
    held, lead, trail, nearest = 0, [], [], []
    replays = [s for s in spans if s.name == "jit.replay"]
    for s in replays:
        a, b = s.t0 + off_ns, s.t1 + off_ns
        j = bisect.bisect_left(starts, a)
        inside = [(x, y) for x, y in launches[j:j + 3] if y <= b]
        if inside:
            held += 1
            lead.append(inside[0][0] - a)
            trail.append(b - inside[0][1])
        # the launch nearest the span's start: how far the clocks could be
        # apart where none is inside
        near = starts[max(0, j - 1):j + 1]
        if near:
            nearest.append(min(near, key=lambda x: abs(x - a)) - a)
    # idle device gaps over the profiled tasks, by the innermost program
    # span the host was in at the gap's middle
    t_lo = min(s.t0 for s in spans) + off_ns
    t_hi = max(s.t1 for s in spans) + off_ns
    dev = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in events if e.device_type() == DeviceType.CUDA
                 and e.start_ns() + e.duration_ns() > t_lo
                 and e.start_ns() < t_hi)
    busy, edge, gaps = 0, t_lo, []
    for a, b in dev:
        a, b = max(a, t_lo), min(b, t_hi)
        if a > edge:
            gaps.append((edge, a))
        busy += max(0, b - max(a, edge))
        edge = max(edge, b)
    if t_hi > edge:
        gaps.append((edge, t_hi))
    conv = sorted((s.t0 + off_ns, s.t1 + off_ns, s.name) for s in spans)
    conv_starts = [c[0] for c in conv]
    by_span = collections.Counter()
    for a, b in gaps:
        mid = (a + b) // 2
        j = bisect.bisect_right(conv_starts, mid)
        # the latest-starting span that holds the middle is the innermost
        inner = next((c for c in reversed(conv[max(0, j - 64):j])
                      if mid < c[1]), None)
        by_span[inner[2] if inner else "outside spans"] += (b - a) / 1e9
    row = {"mode": "clock", "cell": args.workload, "seed": args.seed,
           "tasks": len(tasks), "replay_spans": len(replays),
           "graph_launch_events": len(launches),
           "share_holding_their_launch": held / len(replays)
           if replays else None,
           "offset_ns": off_ns,
           "launch_after_span_start_ns_median": statistics.median(lead)
           if lead else None,
           "span_end_after_launch_end_ns_median": statistics.median(trail)
           if trail else None,
           "nearest_launch_minus_span_start_ns": [
               min(nearest), statistics.median(nearest), max(nearest)]
           if nearest else None, "idle_s": (t_hi - t_lo - busy) / 1e9,
           "stretch_s": (t_hi - t_lo) / 1e9, "busy_s": busy / 1e9,
           "idle_s_by_program_span": dict(by_span.most_common(12))}
    return [row]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("cost", "split", "interleave",
                                     "clock"))
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--windows", default="off,on,on,off")
    ap.add_argument("--tasks", type=int, default=32)
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "runtime_spans_out"))
    args = ap.parse_args(argv)
    if args.mode == "cost":
        rows = [cost(args.repeat)]
        import torch
        if torch.cuda.is_available():
            rows[0]["on_us_a_call"] = card_calls(args.repeat)
    else:
        if not args.workload:
            ap.error(f"{args.mode} needs --workload")
        print(card(), flush=True)
        rows = {"split": split, "interleave": interleave,
                "clock": clock}[args.mode](args)
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{args.mode}-{args.workload}-"
                               f"{args.seed}.jsonl"), "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
