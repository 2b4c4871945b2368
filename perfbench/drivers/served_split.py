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

BOUNDARY_KERNELS = ("fused_boundary", "uaq_dequantize")


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
        fields = dict(
            seq_len=self.seq_len, d_model=self.cfg.d_model,
            launches=launches, wire_bits=J.WIRE_BITS,
            flops_per_task=flops.task_flops(self.conf["model"],
                                            self.seq_len))
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
