"""COACH tasks served through the program's end / cloud split
(``harness/served.py``, a copy of ``launch/serve.py``'s glue), judged by
``harness/judge.py`` against the plain reference."""

from __future__ import annotations

import gc
import importlib

import numpy as np
import torch

from perfbench.harness import judge as J
from perfbench.harness.served import Record, Served
from perfbench.harness.taskstream import task_tokens
from perfbench.harness.work import PEAK_FLOPS

BOUNDARY_KERNELS = ("fused_boundary", "uaq_dequantize")
NUMBERS = ("feat_off", "sims_err", "sep_err", "decisions_off", "payload_off",
           "scale_off", "logits_off")


class Driver(Served):

    def __init__(self, conf, traffic, seed, device, traced=False):
        self.conf, self.traffic = conf, traffic
        super().__init__(conf, traffic, seed, device, traced=traced)

    def draw(self, n):
        return self.stream.tasks(n)

    def record(self, i, task, due):
        return Record(i, task, due=due)

    def serve(self, rec, keep):
        self.serve_task(rec, keep)

    def mark(self):
        return (self.captures(), self.counters(),
                {k: self.launches(k) for k in BOUNDARY_KERNELS})

    def after_window(self, mark, recs, trace_range):
        caps0, launches0, k0 = mark
        launches = self.counters() - launches0
        k1 = {k: self.launches(k) - v for k, v in k0.items()}
        lines = [f"launches {launches}; K1 {k1['fused_boundary']}, K2 "
                 f"{k1['uaq_dequantize']}"]
        if self.captures() != caps0:
            return (f"{self.captures() - caps0} captures inside the window",
                    lines, {})
        if self.dev.type == "cuda" and min(k1.values()) < len(recs):
            return (f"boundary kernels launched {k1} for {len(recs)} tasks",
                    lines, {})
        stats = self.decisions(len(recs))
        lines.append(f"decisions (modelled, not times): exit_ratio "
                     f"{stats.exit_ratio!r} mean_bits {stats.mean_bits!r} "
                     f"wire_kb_per_task {stats.wire_kb_per_task!r}")
        flops = importlib.import_module(
            f"perfbench.flops.{self.conf['kind']}")
        dtype = self.conf["dtype"]
        fields = dict(
            seq_len=self.seq_len, d_model=self.cfg.d_model,
            launches=launches, wire_bits=J.WIRE_BITS,
            flops_per_task=flops.task_flops(self.conf["model"],
                                            self.seq_len),
            peak_flops=PEAK_FLOPS[dtype], rows=self.seq_len,
            act_bytes=getattr(torch, dtype).itemsize)
        if trace_range is not None:
            a, b = trace_range
            fields["traced_centers"] = float(
                np.mean([r.n_centers for r in recs[a:b]]))
        return None, lines, fields

    def judge(self, w):
        """The window's outputs against the reference's, the program's
        graphs and pools freed first."""
        recs, sample = w["records"], w["sample"]
        conf, traffic = self.conf, self.traffic
        got = J.program_outputs(recs, self.calib_feat, sample)
        params, S, dev = self.params, self.seq_len, self.dev
        vocab = self.cfg.vocab_size
        calib = [(task_tokens(t, S, vocab), t.label)
                 for t in self.calib_tasks]
        tasks = [(task_tokens(r.task, S, vocab), r.task.label)
                 for r in recs]
        self.close()
        self.params = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        want = J.outputs(conf, params, calib, tasks, sample, S, dev,
                         packets=got["packets"])
        return J.compare(conf, traffic, got, want, [y for _, y in calib],
                         [y for _, y in tasks])


# -------------------------------------------------------------- control
def _bfloat16_reference(bench, cell, conf, traffic, limits, seed, seconds,
                        tasks, dev):
    """The control: the plain reference put in the program's place and
    computed in bfloat16, against the reference in float32, at the cell's
    own size: the same weights, calibration and tasks as a run of that
    seed, as many tasks as a run serves (an open cell's ``rate *
    seconds``; a closed cell's ``tasks``) and the same seeded sample."""
    from perfbench.harness import traffic as T
    from perfbench.harness import weights as W
    from perfbench.harness.main import verdict
    from perfbench.harness.served import CALIB_TASKS, port_config
    from perfbench.harness.taskstream import TaskStream
    from perfbench.harness.window import sample_of
    from repro_torch.models import model as M

    dtype = torch.bfloat16
    cfg = port_config(conf)
    S = int(traffic["seq_len"])
    meta = M.init_params(cfg, device="meta")
    params = W.make(meta, seed, dev)
    stream = TaskStream(n_labels=int(traffic["n_labels"]), dim=cfg.d_model,
                        correlation=traffic["correlation"], seed=seed)
    due = T.due_times(traffic, seconds)
    n = len(due) if due is not None else tasks
    calib = [(task_tokens(t, S, cfg.vocab_size), t.label)
             for t in stream.tasks(CALIB_TASKS)]
    served = [(task_tokens(t, S, cfg.vocab_size), t.label)
              for t in stream.tasks(n)]
    calib_labels = [y for _, y in calib]
    labels = [y for _, y in served]
    sample = sample_of(seed, n)
    got = J.serve_like(conf, traffic,
                       J.outputs(conf, params, calib, served, sample, S, dev,
                                 dtype), calib_labels, labels, dtype)
    want = J.outputs(conf, params, calib, served, sample, S, dev,
                     packets=got["packets"])
    numbers = J.compare(conf, traffic, got, want, calib_labels, labels)
    ok, lines = verdict(numbers, limits["limits"])
    return numbers, ok, lines


CONTROLS = {"bfloat16": _bfloat16_reference}
