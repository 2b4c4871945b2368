"""Reading a ``torch.profiler`` trace of a stretch of the window.

The device's operations (kernels, copies, sets) and the host's ``pb.*``
spans come from the profiler's own records, on one clock.  The traced
window is the ``pb.window`` span.  Busy time is the union of the device
operations' intervals inside it.  An idle gap is a stretch of it in which
no operation ran, named by the innermost host span that covers its
middle: any ``pb.*`` span but the window's, as the window (``pb.wait``,
waiting for the next arrival) and the driver open them; the served
split's are ``pb.end_step``, ``pb.cloud_step`` and ``pb.d2h`` (the three
parts of serve's ``classify``), ``pb.decide`` (the scheduler's own work
inside ``decide``, around them) and ``pb.sched`` (``plan_for`` and
``account``); else ``other``."""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

def _events(prof):
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur, name = e.start_ns(), e.duration_ns(), e.name()
        if name.startswith("pb."):
            # a span is recorded on the host and, as an annotation of
            # the work it launched, on the device: only the host's is kept
            if e.device_type() != DeviceType.CUDA:
                host.append((start, start + dur, name))
        elif e.device_type() == DeviceType.CUDA:
            dev.append((start, start + dur, name))
    return dev, host


def concurrent_ns(ops) -> int:
    """The time in which two or more of ``ops`` ((start, end, name)) ran
    at once: a sweep over their starts and ends, an end before a start
    at the same instant."""
    edges = sorted([(a, 1) for a, b, _ in ops if b > a]
                   + [(b, -1) for a, b, _ in ops if b > a])
    total = depth = last = 0
    for t, d in edges:
        if depth >= 2:
            total += t - last
        depth += d
        last = t
    return total


def read(prof) -> dict:
    """{"busy_s", "overlap_s", "window_s", "device_ops", "idle_gaps",
    "kernels": {name: (seconds, count)}} of a closed ``window.Profile``
    (``overlap_s``: the seconds in which two or more device operations
    ran at once); None when the profiler recorded no device operation."""
    dev, host = _events(prof.prof)
    win = [h for h in host if h[2] == "pb.window"]
    if not dev or not win:
        return None
    w0, w1 = win[0][0], win[0][1]
    ops = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                 if b > w0 and a < w1)
    busy: List[Tuple[int, int]] = []
    for a, b, _ in ops:
        if busy and a <= busy[-1][1]:
            busy[-1] = (busy[-1][0], max(busy[-1][1], b))
        else:
            busy.append((a, b))
    busy_ns = sum(b - a for a, b in busy)
    gaps = []
    edge = w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    spans = sorted(h for h in host if h[2] != "pb.window")
    starts = [s[0] for s in spans]
    idle: Dict[str, float] = collections.Counter()
    for a, b in gaps:
        mid = (a + b) // 2
        name = "other"
        # the innermost span that covers it: the latest to start of the
        # few that start before it (they nest at most two deep)
        j = bisect.bisect_right(starts, mid) - 1
        for s in spans[max(0, j - 3):j + 1][::-1]:
            if s[0] <= mid < s[1]:
                name = s[2]
                break
        idle[name] += (b - a) / 1e9
    by_name: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0.0, 0])
    for a, b, n in dev:
        if b > w0 and a < w1:
            by_name[n][0] += (b - a) / 1e9
            by_name[n][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": busy_ns / 1e9,
        "overlap_s": concurrent_ns(ops) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "device_ops": [[n[:120], s] for n, (s, _) in top[:10]],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:10],
        "kernels": {n: (s, c) for n, (s, c) in by_name.items()},
    }


def kernel_time(tr: dict, part: str):
    """(device seconds, launches) of the kernels whose name holds
    ``part``; None when there is none."""
    hits = [v for n, v in tr["kernels"].items() if part in n]
    if not hits:
        return None
    return sum(s for s, _ in hits), sum(c for _, c in hits)
