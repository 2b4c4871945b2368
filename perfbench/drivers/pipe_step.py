"""COACH's two-pod pipelined step on one card: the program's
``make_collab_pipeline_step`` with both pods in this process, each on a
CUDA stream of its own (``PodMesh.on_card``), so that pod 0 (the end)
runs microbatch t + 1 while pod 1 (the cloud) runs microbatch t; K3
``uaq_quantize`` and K2 ``uaq_dequantize`` on the hop; the whole step
one CUDA graph under the program's ``core.jit``, captured in set-up.

A task is one step over the traffic's ``(n_micro, batch, seq_len)``
token ids, drawn uniformly over the vocabulary from the seed and the
step's index.  Its answer is each microbatch's last-token logits, copied
to the host; it is ``ok`` when they are finite.

``correct``: for each of the window's sampled steps (the reservoir's
slots), microbatch ``slot % n_micro`` is compared with the plain
reference (``perfbench/reference/<kind>.py``'s ``pipeline``: the first
pod's layers in float32, the boundary through the deployment's wire, the
second pod's layers, the head), so that each tick position of the step
is compared.  The numbers compared, over the compared microbatches:

  logits_err  the largest max|d| / max|ref| of one microbatch's logits
              (a tail: one sequence or one vocabulary row far off)
  logits_l2   the largest ||d|| / ||ref|| of one microbatch's logits (the
              steadier whole: every row of the microbatch)
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import time

import numpy as np
import torch

from perfbench.harness import weights as W
from perfbench.harness import window
from perfbench.harness.served import port_config
from perfbench.harness.window import span
from perfbench.harness.work import PEAK_FLOPS

NUMBERS = ("logits_err", "logits_l2")
WIRE_KERNELS = ("uaq_quantize", "uaq_dequantize")


@dataclasses.dataclass
class Record(window.Record):
    """One step; ``task`` holds its token ids (n_micro, batch, seq_len)."""
    logits: torch.Tensor = None  # (n_micro, batch, V), sampled steps only

    def drop(self):
        self.logits = None


def step_tokens(seed: int, i: int, shape, vocab: int) -> np.ndarray:
    """Step ``i``'s token ids, int32 of ``shape``, uniform over
    ``vocab``."""
    rng = np.random.default_rng([int(seed), 3, int(i)])
    return rng.integers(0, vocab, shape, dtype=np.int32)


def meta_params(conf):
    from repro_torch.models import model as M
    return M.init_params(port_config(conf),
                         dtype=getattr(torch, conf["dtype"]), device="meta")


def sampled_tokens(sample, tokens_of, n_micro):
    """The compared microbatches' token ids, (len(sample) * batch,
    seq_len): slot ``k`` of the reservoir compares step ``sample[k]``'s
    microbatch ``k % n_micro``."""
    return np.concatenate([tokens_of(i)[k % n_micro]
                           for k, i in enumerate(sample)])


def reference_logits(conf, params, tokens: np.ndarray, device,
                     dtype=torch.float32) -> np.ndarray:
    """The reference's two pods composed, on ``tokens`` (rows, seq_len):
    (rows, V) float32."""
    ref = importlib.import_module(f"perfbench.reference.{conf['kind']}")
    dep = conf["deployment"]
    with torch.no_grad():
        out = ref.pipeline(params, conf["model"],
                           torch.as_tensor(tokens, device=device),
                           dep["layers_per_pod"], dep["wire_bits"], dtype)
    return out.cpu().numpy()


def compare(got: np.ndarray, want: np.ndarray, batch: int):
    """The numbers compared, of ``got`` against ``want`` (rows, V), a
    microbatch every ``batch`` rows."""
    err = l2 = 0.0
    for a in range(0, len(want), batch):
        g, w = got[a:a + batch], want[a:a + batch]
        d = (g - w).astype(np.float64)
        err = max(err, float(np.max(np.abs(d)) / np.max(np.abs(w))))
        l2 = max(l2, float(np.linalg.norm(d) / np.linalg.norm(w)))
    return {"logits_err": err, "logits_l2": l2}


class Driver:

    def __init__(self, conf, traffic, seed, device, traced=False):
        self.conf, self.seed = conf, seed
        self.dev = torch.device(device)
        self.traced = traced
        self.n_micro, self.batch, S = (int(traffic[k]) for k in
                                       ("n_micro", "batch", "seq_len"))
        self.shape = (self.n_micro, self.batch, S)
        self.seq_len = self.n_micro * self.batch * S  # tokens a step
        self.cfg = cfg = port_config(conf)
        dep = conf["deployment"]
        if cfg.num_groups % 2 or \
                cfg.num_groups // 2 * cfg.group_size != dep["layers_per_pod"]:
            raise RuntimeError(
                f"the step gives each pod half of {cfg.num_groups} groups of "
                f"{cfg.group_size}; the configuration states "
                f"{dep['layers_per_pod']} layers a pod")
        self.params = W.make(meta_params(conf), seed, self.dev)
        on_cuda = self.dev.type == "cuda"
        if on_cuda:
            # the weights' float32 draw is the harness's: the peak
            # reported is the program's, beside its weights
            torch.cuda.reset_peak_memory_stats(self.dev)
        # the logits come to the host into one page-locked buffer, which
        # the card copies into directly, not staged through pageable memory
        self.host = torch.empty((self.n_micro, self.batch, cfg.vocab_size),
                                dtype=getattr(torch, conf["dtype"]),
                                pin_memory=on_cuda)
        self.drawn = 0
        self.jitted = self.step = None
        self.set_bits(int(dep["wire_bits"]))

    def make_step(self, bits):
        """The program's step, jitted: one CUDA graph a shape."""
        from repro_torch.core.collab import (PodMesh,
                                             make_collab_pipeline_step)
        from repro_torch.core.jit import jit
        return jit(make_collab_pipeline_step(
            self.cfg, PodMesh.on_card(self.dev), bits=bits,
            n_micro=self.n_micro))

    def set_bits(self, bits):
        """(Re)build the step with a ``bits``-bit wire and capture it; on
        the card its capture has to launch K3 and K2 once a microbatch."""
        from repro_torch.kernels import _build as KB
        self.jitted = self.step = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        self.bits = bits
        self.jitted = self.step = self.make_step(bits)
        before = {k: KB.LAUNCHES[k] for k in WIRE_KERNELS}
        self.warm_up()
        self.capture_launches = {k: KB.LAUNCHES[k] - v
                                 for k, v in before.items()}
        if self.dev.type == "cuda" and \
                min(self.capture_launches.values()) < self.n_micro:
            raise RuntimeError(f"the captured step launched "
                               f"{self.capture_launches} for {self.n_micro} "
                               f"microbatches")

    # ---------------------------------------------------------- the task
    def draw(self, n):
        V = self.cfg.vocab_size
        out = [step_tokens(self.seed, self.drawn + j, self.shape, V)
               for j in range(n)]
        self.drawn += n
        return out

    def record(self, i, task, due):
        return Record(i, task, due=due)

    def warm_up(self):
        """The cell's one shape, twice: the first call captures."""
        toks = torch.zeros(self.shape, dtype=torch.int32, device=self.dev)
        with torch.no_grad():
            for _ in range(2):
                self.host.copy_(self.step(self.params, toks))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def serve(self, rec, keep):
        on = self.traced
        with torch.no_grad():
            with span("h2d", on):
                toks = torch.as_tensor(rec.task, device=self.dev)
            with span("step", on):
                logits = self.step(self.params, toks)
                finite = torch.isfinite(logits).all()
            with span("d2h", on):
                self.host.copy_(logits)
                rec.ok = bool(finite)
        rec.end = time.perf_counter()
        if keep:
            rec.logits = self.host.clone()

    # -------------------------------------------------------- the counters
    def counters(self) -> int:
        """Host launches so far: the jitted step's graph replays, input
        copies and output clones, and kernel launches outside a graph."""
        from repro_torch.kernels import _build as KB
        return (self.jitted.replays + self.jitted.copies
                + sum(KB.LAUNCHES.values()))

    def mark(self):
        return self.jitted.captures, self.counters()

    def after_window(self, mark, recs, trace_range):
        caps0, launches0 = mark
        launches = self.counters() - launches0
        lines = [f"launches {launches} ({self.jitted.replays} replays); "
                 f"the capture launched {self.capture_launches}; wire "
                 f"{self.bits} bits"]
        if self.jitted.captures != caps0:
            return (f"{self.jitted.captures - caps0} captures inside the "
                    f"window", lines, {})
        flops = importlib.import_module(
            f"perfbench.flops.{self.conf['kind']}")
        dtype = self.conf["dtype"]
        # a K3 or K2 call on the hop takes one microbatch's boundary:
        # batch x seq_len rows of d_model, in the configuration's dtype
        return None, lines, dict(
            seq_len=self.seq_len, launches=launches,
            flops_per_task=flops.step_flops(self.conf["model"], *self.shape),
            peak_flops=PEAK_FLOPS[dtype], rows=self.batch * self.shape[2],
            d_model=self.cfg.d_model, wire_bits=self.bits,
            act_bytes=getattr(torch, dtype).itemsize)

    # ------------------------------------------------------ the comparison
    def close(self):
        """Drop the step's graph, its memory pool and its streams."""
        self.jitted = self.step = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    def judge(self, w):
        recs, sample = w["records"], w["sample"]
        n = self.n_micro
        got = np.concatenate([recs[i].logits[k % n].float().numpy()
                              for k, i in enumerate(sample)])
        toks = sampled_tokens(sample, lambda i: recs[i].task, n)
        params, self.params = self.params, None
        self.close()
        want = reference_logits(self.conf, params, toks, self.dev)
        return compare(got, want, self.batch)


# ------------------------------------------------------------- controls
def _fp8_reference(bench, cell, conf, traffic, limits, seed, seconds, tasks,
                   dev):
    """The reference with every product's operands rounded to e4m3 in
    the program's place, on the steps a run of ``tasks`` steps samples."""
    from perfbench.harness.main import verdict
    from perfbench.harness.window import sample_of
    from perfbench.reference.dense import FP8
    shape = tuple(int(traffic[k]) for k in ("n_micro", "batch", "seq_len"))
    V = conf["model"]["vocab_size"]
    params = W.make(meta_params(conf), seed, dev)
    toks = sampled_tokens(sample_of(seed, tasks),
                          lambda i: step_tokens(seed, i, shape, V), shape[0])
    want = reference_logits(conf, params, toks, dev)
    got = reference_logits(conf, params, toks, dev, FP8)
    numbers = compare(got, want, shape[1])
    ok, lines = verdict(numbers, limits["limits"])
    return numbers, ok, lines


def wire(bits):
    """A fault: the step built with a ``bits``-bit wire."""
    def fault(drv):
        drv.set_bits(bits)
    return fault


def _wire4(bench, cell, conf, traffic, limits, seed, seconds, tasks, dev):
    """A run of the cell whose step has a 4-bit wire."""
    from perfbench.harness.main import execute
    out = execute(bench, cell, conf, traffic, limits, seed, seconds, False,
                  dev, time.time(), fault=wire(4))
    if isinstance(out, int):
        raise RuntimeError(f"the run ended with code {out}")
    numbers = {k: v["value"] for k, v in out["checks"].items()}
    return numbers, out["correct"], out["_lines"]


CONTROLS = {"float8_e4m3fn": _fp8_reference, "wire4": _wire4}
