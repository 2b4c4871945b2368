"""The served split, set up and driven one task at a time: a copy of the
glue in ``repro_torch.launch.serve.serve(arch, smoke=False,
params=...)``, which has no entry that separates its set-up from the
per-task path.

Set-up is serve's, in its order: the planner on
``transformer_graph(cfg, batch=1, seq=128)`` (Jetson NX end, A6000
cloud, WiFi link), the cut mapped to a group, ``CollabRuntime``, the
300-task calibration through the jitted end segment, ``CoachEngine``.
Then the cell's one task shape is warmed up, so that every segment's
CUDA graph is captured before the window.  Tasks hold at most
``PLAN_SEQ`` tokens, the length serve plans the cut and the scheduler's
packet for.

``serve_task`` is the body of ``CoachEngine.run_stream``'s loop
(``decide`` -> ``plan_for`` -> ``account``) with serve's ``classify``:
the fused end step (end segment graph + K1 ``fused_boundary``), the
cloud step (K2 ``uaq_dequantize`` + cloud segment graph), and the host
copies of the probe outputs and the logits.  It records, per task, the
host timestamps and what the program produced, for the comparison that
decides ``correct``."""

from __future__ import annotations

import dataclasses
import importlib
import math
import time
from typing import List

import numpy as np
import torch

from perfbench.harness import weights as W
from perfbench.harness import window
from perfbench.harness.taskstream import TaskStream, task_tokens
from perfbench.harness.window import span

CALIB_TASKS = 300
CALIB_TOKENS = 4096  # tokens a calibration batch at most
# serve plans the cut and sizes the scheduler's packet (Eq. 11) for tasks
# of this many tokens; a longer task would be served on a plan for a
# smaller packet than it sends
PLAN_SEQ = 128


def calib_batch(seq_len: int) -> int:
    """The largest divisor of the calibration's 300 tasks whose batch
    holds at most ``CALIB_TOKENS`` tokens (serve's one batch at S = 8)."""
    return max(d for d in range(1, CALIB_TASKS + 1)
               if CALIB_TASKS % d == 0 and (d * seq_len <= CALIB_TOKENS
                                            or d == 1))


def port_config(conf: dict):
    """The program's model configuration, as the configuration file
    states it: the ``CONFIG`` of the port module that the file names as
    ``module``, with the file's ``model`` applied over it.  ``CONFIG``
    may be of a subclass of ``ModelConfig`` with fields of its own, which
    ``model`` may set.  A module that does not import, or holds no
    ``ModelConfig`` as ``CONFIG``, stops the run before any weights are
    made, with an error that names the file and the module."""
    from repro_torch.models.config import ModelConfig
    name = conf.get("module")
    where = f"configuration {conf.get('file', conf.get('name'))}, " \
        f"module {name!r}"
    try:
        mod = importlib.import_module(name)
    except Exception as e:  # whatever stops the module importing
        raise ValueError(f"{where}: does not import ({e!r})") from e
    base = getattr(mod, "CONFIG", None)
    if not isinstance(base, ModelConfig):
        raise ValueError(f"{where}: CONFIG is {type(base).__name__}, "
                         f"not a ModelConfig")
    try:
        return dataclasses.replace(base, **conf["model"])
    except TypeError as e:  # a key of ``model`` that CONFIG has no field for
        raise ValueError(f"{where}: {e}") from e


def plan(cfg, link):
    """serve's offline step: the planner on the cost graph, and its cut
    mapped to a group boundary (embed node is id 0)."""
    from repro_torch.core.costs import (A6000_SERVER, JETSON_NX,
                                        transformer_graph)
    from repro_torch.core.partitioner import coach_offline
    graph = transformer_graph(cfg, batch=1, seq=PLAN_SEQ)
    off = coach_offline(graph, JETSON_NX, A6000_SERVER, link)
    n_end = sum(1 for i in off.decision.end_set if 0 < i <= cfg.num_layers)
    cut = min(max(1, round(n_end / cfg.group_size)), cfg.num_groups - 1)
    return cut, off


def deployment(cut, off) -> dict:
    """The planner's choice as a configuration file states it."""
    return {"cut_group": cut, "T_e": off.times.T_e, "T_c": off.times.T_c,
            "period": off.times.max_stage}


@dataclasses.dataclass
class Record(window.Record):
    """One served task."""
    classify_s: float = 0.0
    sched_s: float = 0.0      # decide + plan_for + account, less classify
    n_centers: int = 0
    feat: np.ndarray = None
    sims: np.ndarray = None   # over the trained centers
    sep: float = 0.0
    best: int = 0
    valid: np.ndarray = None
    exit: bool = False
    bits: int = 0
    logits: np.ndarray = None  # kept for the sampled tasks only
    packet: tuple = None       # (payload, scale, zp), sampled tasks only

    def drop(self):
        self.packet = self.logits = None


class Served:
    def __init__(self, conf: dict, traffic: dict, seed: int, device,
                 traced: bool = False):
        from repro_torch.core.collab import CollabRuntime
        from repro_torch.core.costs import (A6000_SERVER, JETSON_NX,
                                            WIFI_5GHZ)
        from repro_torch.models import model as M
        from repro_torch.serving.engine import CoachEngine, EngineConfig

        self.dev = torch.device(device)
        self.traced = traced
        self.seq_len = S = int(traffic["seq_len"])
        if S > PLAN_SEQ:
            raise ValueError(f"tasks of {S} tokens: the deployment is "
                             f"planned for tasks of at most {PLAN_SEQ}")
        self.cfg = cfg = port_config(conf)
        meta = M.init_params(cfg, dtype=getattr(torch, conf["dtype"]),
                             device="meta")
        self.params = W.make(meta, seed, self.dev)

        link = WIFI_5GHZ(float(traffic["bandwidth_mbps"]))
        cut, off = plan(cfg, link)
        self.period = off.times.max_stage
        got = deployment(cut, off)
        dep = conf["deployment"]
        for k, v in got.items():
            if not math.isclose(v, dep[k], rel_tol=1e-9, abs_tol=1e-15):
                raise RuntimeError(
                    f"the planner chose {k}={v!r}, the configuration "
                    f"states {dep[k]!r}: {got}")
        self.rt = rt = CollabRuntime(cfg, self.params, cut)

        n_labels = int(traffic["n_labels"])
        self.stream = TaskStream(n_labels=n_labels, dim=cfg.d_model,
                                 correlation=traffic["correlation"],
                                 seed=seed)
        self.calib_tasks = self.stream.tasks(CALIB_TASKS)
        b = calib_batch(S)
        feats = []
        with torch.no_grad():
            for i in range(0, CALIB_TASKS, b):
                inp = torch.cat([self.task_input(t)
                                 for t in self.calib_tasks[i:i + b]], dim=0)
                h = rt._seg_fns[0](rt.p_end, inp)
                # serve's sum / seq_len GAP
                feats.append((torch.sum(h.to(torch.float32), dim=1)
                              / h.shape[1]).cpu().numpy())
                del h
        labels = np.asarray([t.label for t in self.calib_tasks])
        self.calib_feat = np.concatenate(feats)
        self.engine = CoachEngine(
            rt, off.times, JETSON_NX, link, A6000_SERVER, n_labels=n_labels,
            calib_feats=self.calib_feat, calib_labels=labels,
            boundary_elems=PLAN_SEQ * cfg.d_model, cfg=EngineConfig())
        self.plans: List = []
        self.acc = {"exits": 0, "wire": 0.0, "bits": [], "correct": []}
        self.n_labels = n_labels
        self.warm_up()

    # ---------------------------------------------------------- the task
    def task_input(self, task):
        toks = task_tokens(task, self.seq_len, self.cfg.vocab_size)
        return torch.as_tensor(toks, device=self.dev)[None]

    def warm_up(self):
        """The cell's one shape through both segments and K1 / K2, twice
        (the first call captures each segment's graph), without touching
        the scheduler's state."""
        centers, _ = self.engine.sched.probe_centers()
        c = torch.as_tensor(centers, dtype=torch.float32, device=self.dev)
        inp = torch.zeros((1, self.seq_len), dtype=torch.int32,
                          device=self.dev)
        with torch.no_grad():
            for _ in range(2):
                pkt, probe = self.rt.end_step_fused(inp, c)
                self.rt.cloud_step(pkt)[0].cpu()
                probe.feat.cpu()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def serve_task(self, rec: Record, keep: bool):
        """Serve ``rec.task``; ``keep`` keeps its packet and logits."""
        from repro_torch.core import online as ON
        engine, rt, dev, on = self.engine, self.rt, self.dev, self.traced

        def classify(task):
            t0 = time.perf_counter()
            with span("end_step", on):
                centers, valid = engine.sched.probe_centers()
                pkt, probe = rt.end_step_fused(
                    self.task_input(task),
                    torch.as_tensor(centers, dtype=torch.float32,
                                    device=dev))
            with span("cloud_step", on):
                logits = rt.cloud_step(pkt)
            with span("d2h", on):
                sims = probe.sims[0].cpu().numpy()
                sep = probe.sep[0].cpu().numpy()
                best = probe.best[0].cpu().numpy()
                pr = ON.ProbeResult.from_fused(sims, sep, best, valid,
                                               n_labels=self.n_labels)
                feat = probe.feat[0].cpu().numpy()
                lg = logits[0].cpu().numpy()
                pred = int(np.argmax(lg) % self.n_labels)
            rec.n_centers = len(valid)
            rec.feat, rec.sims, rec.sep, rec.best = feat, sims, float(sep), \
                int(best)
            rec.valid = valid
            rec.ok = bool(np.isfinite(lg).all())
            if keep:
                rec.logits = lg
                rec.packet = (pkt.payload, pkt.scale, pkt.zp)
            rec.classify_s = time.perf_counter() - t0
            return feat, pred, pr

        task = rec.task
        bw = engine.link.bps_at(self.period * task.id)
        t_a = time.perf_counter()
        with span("decide", on):
            dec, feats, pred = engine.decide(task, bw, classify)
        with span("sched", on):
            plan, wire_bits = engine.plan_for(dec, bw)
            self.plans.append(plan)
            engine.account(dec, feats, pred, task, wire_bits, self.acc)
        rec.end = time.perf_counter()
        rec.sched_s = rec.end - t_a - rec.classify_s
        rec.exit, rec.bits = bool(dec.early_exit), int(dec.bits or 0)

    def decisions(self, n: int):
        """serve's closing statistics over the window's plans, from the
        planner's modelled times (never reported as times)."""
        from repro_torch.core.pipeline import run_pipeline
        e = self.engine
        pr = run_pipeline(self.plans, arrival_period=self.period,
                          links=e.links, batch_caps=e.batch_caps,
                          pools=e.pools, router=e.make_router(), sink=None,
                          migrate=e.cfg.migrate)
        return e._stats(pr, n, self.acc["exits"], self.acc["bits"],
                        self.acc["wire"], self.acc["correct"])

    def counters(self) -> int:
        """Host launches so far: the jitted segments' graph replays and
        copies, and the boundary kernels' launches."""
        from repro_torch.kernels import _build as KB
        fns = {id(f): f for f in self.rt._seg_fns}.values()
        return (sum(f.replays + f.copies for f in fns)
                + sum(KB.LAUNCHES.values()))

    def captures(self) -> int:
        fns = {id(f): f for f in self.rt._seg_fns}.values()
        return sum(f.captures for f in fns)

    def launches(self, name: str) -> int:
        from repro_torch.kernels import _build as KB
        return KB.LAUNCHES[name]

    def close(self):
        """Drop the program's state (graphs, pools, engine): the
        reference runs after it, on the same card."""
        self.engine = self.rt = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()
