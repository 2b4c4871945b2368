"""The comparison that decides ``correct``.

The plain reference (``perfbench/reference/<kind>.py``) gets the run's
weights and task inputs and computes, independently of the program, in
blocks of rows: the end segment of the 300 calibration tasks and of every
served task at the configuration's stated cut, and their GAP features;
for a sample of the served tasks drawn from the seed, the 8-bit wire
packet and, from its own dequantized packet, the cloud segment's logits.

The semantic cache is a chain: each decision moves the centers that the
next task is probed against, so a rounding-level difference in one
feature can flip a later decision and make every state after it differ.
So the probe and the scheduler are checked by following the program step
by step, and the stage this starts from (the features) is checked by
itself against the independent reference: the reference scheduler is
calibrated on the program's calibration features, probes the program's
feature of each served task against its own centers (Eq. 8-9), decides
from the program's probe (Eq. 10-11) and updates its cache with the
program's feature.  The cut, the stage times and the link are the
configuration's stated deployment.

The wire packet's stage is checked by itself against the independent
reference (payload, scale), and the cloud segment from the program's own
packet: the reference dequantizes the program's packet of each sampled
task and runs its cloud segment on it.  (From its own packet, a payload
byte one step off, which rounding makes in ~1e-4 of the bytes, moves
the logits by up to ~1e-2, and moves a MoE layer's expert choice.)

The numbers compared, each against its cell's limit:

  feat_off       share of calibration and served tasks whose feature
                 differs from the reference's by more than FEAT_TOL of
                 its largest value                     (independent)
  sims_err       max over served tasks of max|sims - ref probe|
  sep_err        max over served tasks of |sep - ref probe's|
  decisions_off  share of served tasks whose trained centers, exit, bits
                 or best label differ from the reference's (a best label
                 within TIE of the runner-up is a tie, not a miss)
  payload_off    share of the sampled packets' payload bytes that differ
                                                       (independent)
  scale_off      share of the sampled packets' rows whose scale differs
                 by more than SCALE_TOL relatively     (independent)
  logits_off     share of the sampled tasks whose logits differ from the
                 reference's (from the program's packet) by more than
                 LOGITS_TOL of their largest value

Shares and not maxima where a rare event moves one task far: a MoE
router whose two best experts lie within rounding of each other sends
one token elsewhere on the two sides (in ~1e-3 of the 512-token tasks).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness.served import PLAN_SEQ
from perfbench.reference import common as RC

WIRE_BITS = 8           # the packet's precision: CollabRuntime's default
BLOCK_TOKENS = 1 << 16  # tokens a reference block at most
FEAT_TOL = 1e-4    # ~25x fp32's readings (<= 4.5e-6), 1/100 of bf16's
SCALE_TOL = 1e-4   # ~10x fp32's readings (<= 1.2e-5), 1/100 of bf16's
LOGITS_TOL = 1e-3  # ~100x fp32 through the cloud segment, 1/20 of bf16's
TIE = 1e-6


def reference(kind: str):
    return importlib.import_module(f"perfbench.reference.{kind}")


def _blocks(n, seq_len):
    b = max(1, BLOCK_TOKENS // seq_len)
    return [(i, min(n, i + b)) for i in range(0, n, b)]


def outputs(conf: dict, params, calib: List, tasks: List, sample: List[int],
            seq_len: int, device, dtype=torch.float32,
            packets: Dict = None) -> Dict:
    """The reference's features, sampled packets and logits; ``calib`` and
    ``tasks`` are ``(tokens, label)`` pairs, the tasks in served order.
    The logits are the cloud segment's on ``packets`` (the program's,
    ``{task: (payload, scale, zp)}``) where given, else on its own.
    ``dtype`` below float32 makes the control."""
    ref = reference(conf["kind"])
    model = conf["model"]
    cut = conf["deployment"]["cut_group"]

    def end(toks):
        x = torch.as_tensor(np.stack(toks), device=device)
        return ref.forward(params, model, x, range(cut), dtype, first=True)

    want = sorted(set(sample))
    out = {"calib_feat": [], "feat": [], "packets": {}, "logits": {}}
    received = {}
    with torch.no_grad():
        for a, b in _blocks(len(calib), seq_len):
            out["calib_feat"].append(RC.gap(end([t for t, _ in calib[a:b]]))
                                     .cpu().numpy())
        for a, b in _blocks(len(tasks), seq_len):
            h = end([t for t, _ in tasks[a:b]])
            out["feat"].append(RC.gap(h).cpu().numpy())
            for i in want:
                if a <= i < b:
                    hi = h[i - a]
                    pkt = RC.quantize(hi, WIRE_BITS)
                    out["packets"][i] = tuple(t.cpu() for t in pkt)
                    if packets is not None:
                        pkt = tuple(t.to(device).reshape(w.shape) for t, w
                                    in zip(packets[i], pkt))
                    received[i] = RC.dequantize(*pkt, WIRE_BITS,
                                                hi.shape[-1]).to(dtype)
            del h
        for a, b in _blocks(len(want), seq_len):
            hd = torch.stack([received.pop(i) for i in want[a:b]])
            logits = ref.forward(params, model, hd,
                                 range(cut, model["num_layers"]), dtype,
                                 last=True).cpu().numpy()
            out["logits"].update(zip(want[a:b], logits))
    out["calib_feat"] = np.concatenate(out["calib_feat"])
    out["feat"] = np.concatenate(out["feat"])
    return out


def scheduler(conf, traffic, calib_feat, calib_labels):
    model, dep = conf["model"], conf["deployment"]
    return RC.Scheduler(int(traffic["n_labels"]), calib_feat,
                        np.asarray(calib_labels), PLAN_SEQ * model["d_model"],
                        dep["T_e"], dep["T_c"],
                        float(traffic["bandwidth_mbps"]) * 1e6)


def serve_like(conf, traffic, out: Dict, calib_labels, labels,
               dtype) -> Dict:
    """``out`` (a reference's ``outputs``) with the probe and decisions
    that a program computing in ``dtype`` would give: the control's."""
    sched = scheduler(conf, traffic, out["calib_feat"], calib_labels)
    out = dict(out, sims=[], sep=[], best=[], valid=[], decisions=[])
    for f, label in zip(out["feat"], labels):
        centers, valid = sched.trained()
        sims, sep, best = RC.probe(f, centers, dtype)
        out["sims"].append(sims)
        out["sep"].append(sep)
        out["best"].append(best)
        out["valid"].append(valid)
        out["decisions"].append(sched.serve(
            f.astype(np.float64), sep, int(valid[best]), len(valid), label))
    return out


def compare(conf, traffic, got: Dict, want: Dict, calib_labels,
            labels) -> Dict[str, float]:
    """The numbers compared, of the program's outputs ``got`` (features,
    probes, decisions, sampled packets and logits) against the
    reference's ``want`` (``outputs``)."""
    def rel(a, b):
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))

    feats = list(zip(list(got["calib_feat"]) + list(got["feat"]),
                     list(want["calib_feat"]) + list(want["feat"])))
    feat_off = sum(rel(g, w) > FEAT_TOL for g, w in feats) / len(feats)
    sched = scheduler(conf, traffic, got["calib_feat"], calib_labels)
    sims_err = sep_err = 0.0
    off = 0
    for i, label in enumerate(labels):
        centers, valid = sched.trained()
        f = got["feat"][i]
        sims, sep, best = RC.probe(f, centers)
        miss = not np.array_equal(got["valid"][i], valid)
        if not miss:
            sims_err = max(sims_err, float(np.max(np.abs(got["sims"][i]
                                                         - sims))))
            sep_err = max(sep_err, abs(got["sep"][i] - sep))
            gb = int(got["best"][i])
            miss = gb != best and sims[best] - sims[gb] > TIE
        dec = sched.serve(f.astype(np.float64), got["sep"][i],
                          int(valid[min(int(got["best"][i]),
                                        len(valid) - 1)]), len(valid), label)
        off += miss or tuple(got["decisions"][i]) != dec
    pay_off = pay_all = rows_off = rows = logits_off = 0
    for i, (p, s, z) in want["packets"].items():
        gp, gs, gz = (t.reshape(w.shape) for t, w in zip(got["packets"][i],
                                                         (p, s, z)))
        pay_off += int(torch.count_nonzero(gp != p))
        pay_all += p.numel()
        rows_off += int(torch.count_nonzero(torch.abs(gs - s) > SCALE_TOL
                                            * torch.abs(s)))
        rows += s.numel()
        logits_off += rel(got["logits"][i], want["logits"][i]) > LOGITS_TOL
    return {"feat_off": feat_off, "sims_err": sims_err, "sep_err": sep_err,
            "decisions_off": off / len(labels),
            "payload_off": pay_off / pay_all, "scale_off": rows_off / rows,
            "logits_off": logits_off / len(want["packets"])}


def program_outputs(records, calib_feat, sample: List[int]) -> Dict:
    """What the program produced, as ``outputs`` and ``serve_like`` give
    the reference's."""
    return {
        "calib_feat": calib_feat,
        "feat": np.stack([r.feat for r in records]),
        "sims": [r.sims for r in records],
        "sep": [r.sep for r in records],
        "best": [r.best for r in records],
        "valid": [np.asarray(r.valid) for r in records],
        "decisions": [(r.exit, r.bits) for r in records],
        "packets": {i: tuple(t.cpu() for t in records[i].packet)
                    for i in sample},
        "logits": {i: records[i].logits for i in sample},
    }
