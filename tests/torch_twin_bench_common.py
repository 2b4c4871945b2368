"""Shared benchmark scenario: the paper's testbed (ResNet101/VGG16 on
Jetson NX/TX2 + shared A6000 over WiFi) built from this repo's subsystems.

``run_coach``    — offline partition (Alg. 1) + online semantic cache on a
                   correlated task stream + 3-stage pipeline accounting.
``run_baseline`` — NS / DADS / SPINN / JPS on the same cost model & stream
                   (SPINN gets its fixed-threshold early exit).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core import baselines as BL
from repro_torch.core import online as ON
from repro_torch.core.costs import (A6000_SERVER, JETSON_NX, JETSON_TX2, LinkProfile,
                              ModelGraph, WIFI_5GHZ)
from repro_torch.core.partitioner import coach_offline
from repro_torch.core.pipeline import TaskPlan, run_pipeline
from repro_torch.core.schedule import StageTimes
from repro_torch.data.pipeline import CorrelatedTaskStream, make_calibration_set
from repro_torch.obs.bubbles import attribute, chain_resources
from repro_torch.obs.trace import TraceRecorder

DEVICES = {"NX": JETSON_NX, "TX2": JETSON_TX2}
N_LABELS = 30
FEAT_DIM = 48


@dataclasses.dataclass
class RunResult:
    mean_latency_ms: float
    p99_latency_ms: float
    throughput: float
    exit_ratio: float
    wire_kb_per_task: float
    accuracy: float
    cloud_bubbles: float
    link_bubbles: float
    max_stage_ms: float
    # full per-resource, per-cause idle decomposition from obs.bubbles
    # ({label: {cause: seconds}}, zero causes pruned); the scalar
    # cloud_bubbles/link_bubbles keys above stay for schema compatibility
    bubble_causes: Dict[str, Dict[str, float]] = \
        dataclasses.field(default_factory=dict)


def _boundary_elems(graph: ModelGraph, end_set) -> int:
    elems = 0
    for (u, v) in graph.boundary_edges(end_set):
        elems += graph.node(u).out_elems if u >= 0 else graph.input_elems
    return max(elems, 1)


def _stream(correlation: str, seed: int):
    stream = CorrelatedTaskStream(n_labels=N_LABELS, dim=FEAT_DIM,
                                  correlation=correlation, seed=seed)
    feats, labels = make_calibration_set(stream, 400)
    return stream, feats, labels


def _proxy_classifier(stream, quant_bits: Optional[int] = None):
    """Cloud-side classifier: nearest (undrifted) class center; optional
    feature quantization noise ties precision to accuracy."""
    def f(feat):
        x = feat
        if quant_bits is not None:
            lo, hi = x.min(), x.max()
            scale = max(hi - lo, 1e-8) / ((1 << quant_bits) - 1)
            x = np.round((x - lo) / scale) * scale + lo
        d = np.linalg.norm(stream.mu - x[None], axis=1)
        return int(np.argmin(d))
    return f


def _pipeline_result(plans, correct, arrival_period, link, exits) -> RunResult:
    rec = TraceRecorder()
    pr = run_pipeline(plans, arrival_period=arrival_period, link=link,
                      sink=rec)
    att = attribute(rec, resources=chain_resources(
        pr.n_hops, pr.pool_sizes or None))
    causes = {label: {c: s for c, s in cs.items() if s > 0.0}
              for label, cs in att.by_label().items()}
    tx = [p.t_tx for p in plans if not p.early_exit]
    return RunResult(
        mean_latency_ms=pr.mean_latency * 1e3,
        p99_latency_ms=pr.p99_latency * 1e3,
        throughput=pr.throughput,
        exit_ratio=exits / len(plans),
        wire_kb_per_task=float(np.sum([t * link.bandwidth_bps for t in tx])
                               / 8e3 / len(plans)),
        accuracy=float(np.mean(correct)),
        cloud_bubbles=pr.bubble_fraction("cloud"),
        link_bubbles=pr.bubble_fraction("link"),
        max_stage_ms=max(max(p.t_end, p.t_tx, p.t_cloud) for p in plans) * 1e3,
        bubble_causes=causes,
    )


def scenario_arrival(graph: ModelGraph, device: str, mbps: float,
                     slack: float = 1.1) -> float:
    """Shared task arrival period for one scenario: every method (COACH +
    baselines) must be stable, so latency comparisons are like-for-like."""
    end_dev = DEVICES[device]
    link = WIFI_5GHZ(mbps)
    stages = [coach_offline(graph, end_dev, A6000_SERVER, link).times]
    stages += [fn(graph, end_dev, A6000_SERVER, link).times
               for fn in BL.BASELINES.values()]
    return slack * max(s.max_stage for s in stages)


def run_coach(graph: ModelGraph, device="NX", mbps: float = 50.0,
              correlation: str = "medium", n_tasks: int = 600,
              seed: int = 0, trace: Optional[Callable] = None,
              arrival_factor: float = 1.0,
              arrival_period: Optional[float] = None,
              online: bool = True) -> RunResult:
    end_dev = DEVICES[device]
    link = WIFI_5GHZ(mbps)
    if trace is not None:
        link = LinkProfile("wifi-dyn", mbps * 1e6, trace=trace)
    # Eq. 3 latency budget: tasks must not exceed 1.5x the best single-task
    # latency any baseline achieves (the paper's latency-tolerance input)
    off = coach_offline(graph, end_dev, A6000_SERVER, link,
                        T_max=1.5 * BL.neurosurgeon(
                            graph, end_dev, A6000_SERVER, link).times.latency)
    st_ = off.times
    elems = _boundary_elems(graph, off.decision.end_set)

    stream, feats, labels = _stream(correlation, seed)
    cache = ON.SemanticCache(N_LABELS, FEAT_DIM)
    cache.warm_up(feats, labels)
    th = ON.calibrate_thresholds(cache, feats, labels)
    sched = ON.OnlineScheduler(cache, th, elems, st_.T_e, st_.T_c)

    arrival = arrival_period if arrival_period is not None \
        else st_.max_stage * arrival_factor
    plans, correct = [], []
    exits = 0
    for task in stream.tasks(n_tasks):
        bw = link.bps_at(arrival * task.id)
        if online:
            dec = sched.step(task.features, bandwidth_bps=bw)
        else:
            dec = ON.OnlineDecision(False, None, 0.0, None, None)
        if dec.early_exit:
            exits += 1
            plans.append(TaskPlan(st_.T_e, 0.0, 0.0, True))
            correct.append(dec.result == task.label)
        else:
            bits = dec.bits if dec.bits else \
                int(np.mean(list(off.decision.bits.values())) or 8)
            t_tx = elems * bits / link.bandwidth_bps
            plans.append(TaskPlan(st_.T_e, t_tx, st_.T_c,
                                  tx_offset=min(st_.first_tx_offset, st_.T_e),
                                  cloud_offset=st_.cloud_start_offset))
            pred = _proxy_classifier(stream, bits)(task.features)
            correct.append(pred == task.label)
            sched.report_label(task.features, task.label)
    return _pipeline_result(plans, correct, arrival, link, exits)


def run_baseline(name: str, graph: ModelGraph, device="NX",
                 mbps: float = 50.0, correlation: str = "medium",
                 n_tasks: int = 600, seed: int = 0,
                 trace: Optional[Callable] = None,
                 arrival_factor: float = 1.0,
                 arrival_period: Optional[float] = None) -> RunResult:
    end_dev = DEVICES[device]
    link = WIFI_5GHZ(mbps)
    if trace is not None:
        link = LinkProfile("wifi-dyn", mbps * 1e6, trace=trace)
    b = BL.BASELINES[name](graph, end_dev, A6000_SERVER, link)
    st_ = b.times
    elems = _boundary_elems(graph, b.decision.end_set)
    bits = {"ns": 32, "dads": 32, "spinn": 8, "jps": 8}[b.decision.name]

    stream, feats, labels = _stream(correlation, seed)
    # SPINN: fixed-threshold early exit (uncalibrated, conservative)
    spinn_th = None
    cache = None
    if name == "SPINN":
        cache = ON.SemanticCache(N_LABELS, FEAT_DIM)
        cache.warm_up(feats, labels)
        seps = [ON.separability(cache.similarities(f)) for f in feats]
        spinn_th = float(np.quantile(seps, 0.9))

    arrival = arrival_period if arrival_period is not None \
        else st_.max_stage * arrival_factor
    plans, correct = [], []
    exits = 0
    clf = _proxy_classifier(stream, bits if bits < 32 else None)
    for task in stream.tasks(n_tasks):
        if spinn_th is not None:
            sims = cache.similarities(task.features)
            if ON.separability(sims) > spinn_th:
                exits += 1
                plans.append(TaskPlan(st_.T_e, 0.0, 0.0, True))
                correct.append(int(np.argmax(sims)) == task.label)
                cache.update(task.features, int(np.argmax(sims)))
                continue
        # the offline evaluation already priced the boundary (incl. 8-bit
        # raw input for all-cloud cuts); baselines don't adapt per task
        t_tx = st_.T_t
        plans.append(TaskPlan(st_.T_e, t_tx, st_.T_c,
                              tx_offset=min(st_.first_tx_offset, st_.T_e),
                              cloud_offset=st_.cloud_start_offset))
        correct.append(clf(task.features) == task.label)
        if cache is not None:
            cache.update(task.features, task.label)
    return _pipeline_result(plans, correct, arrival, link, exits)


def csv_row(tag: str, r: RunResult) -> str:
    return (f"{tag},{r.mean_latency_ms:.2f},{r.throughput:.1f},"
            f"{r.exit_ratio:.3f},{r.wire_kb_per_task:.1f},{r.accuracy:.3f},"
            f"{r.cloud_bubbles:.3f},{r.max_stage_ms:.2f}")


CSV_HEADER = ("tag,latency_ms,throughput_its,exit_ratio,wire_kb,accuracy,"
              "cloud_bubbles,max_stage_ms")
