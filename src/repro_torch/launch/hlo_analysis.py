"""Collective byte accounting, memory statistics and roofline terms of one
recorded step: the port's counterpart of ``repro.launch.hlo_analysis``
(which reads the compiled HLO).  The quantities come from a
``hlo_cost.StepTrace`` of the step, so they are per device.

Hardware constants are the H100 SXM5 80 GB's (NVIDIA data sheet, 700 W,
dense): 989.4 TFLOP/s bf16 on the tensor cores and 3.35 TB/s of HBM3.
The link model of the roofline's collective term: NVLink 4 joins the 8
GPUs of a node at 900 GB/s a GPU both ways (450 GB/s each way); nodes
are joined by InfiniBand NDR, one 400 Gb/s port a GPU (50 GB/s each
way).  A collective over a mesh axis whose group spans more than one
node runs at the InfiniBand rate, as every axis of the 16x16 and 2x16x16
meshes does (a 16-wide "model" row spans two nodes, the "data" and
"pod" axes stride across nodes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.launch.hlo_cost import _COLLECTIVES, StepTrace

PEAK_FLOPS_BF16 = 989.4e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9  # a GPU, each way (900 GB/s both ways)
IB_BW = 50e9  # a GPU, each way: one NDR 400 Gb/s port a GPU
GPUS_PER_NODE = 8


def link_bw(mesh_shape) -> float:
    """Per-GPU collective rate of a mesh: NVLink when the whole mesh fits
    one node, InfiniBand otherwise."""
    return NVLINK_BW if math.prod(mesh_shape) <= GPUS_PER_NODE else IB_BW


def collective_bytes(trace: StepTrace) -> Dict[str, float]:
    """Sum operand bytes per collective kind (per device); a collective of
    no known kind counts under "other" and in the total."""
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    for op in trace.ops:
        if op.coll_kind:
            out[op.coll_kind] = out.get(op.coll_kind, 0.0) + op.coll_bytes
    out["total"] = sum(v for k, v in out.items())
    return out


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    link_bw: float = IB_BW

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


def memory_stats(trace: StepTrace) -> Dict[str, float]:
    """Per-device bytes: arguments and outputs exactly (local shards);
    temp is the peak of live bytes the step allocated, its outputs
    included; alias is the outputs that reuse an argument's storage (a
    donated, in-place update)."""
    out = {"argument_size_in_bytes": trace.argument_bytes,
           "output_size_in_bytes": trace.output_bytes,
           "temp_size_in_bytes": trace.peak_bytes,
           "alias_size_in_bytes": trace.alias_bytes}
    out["total_nonalias_bytes"] = (
        out["argument_size_in_bytes"] + out["output_size_in_bytes"]
        + out["temp_size_in_bytes"] - out["alias_size_in_bytes"])
    return out


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D for training, 2·N_active·D for inference
    (per the roofline 'useful compute' convention)."""
    n_active = _active_params(cfg)
    toks = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                 else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n_active * toks


def _active_params(cfg) -> float:
    """Parameter count touched per token (MoE counts top-k + shared)."""
    d, f = cfg.d_model, cfg.d_ff
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    for i in range(cfg.num_layers):
        spec = cfg.pattern[i % len(cfg.pattern)]
        if spec.mixer == "attn":
            total += d * cfg.head_dim * (cfg.num_heads * 2
                                         + cfg.num_kv_heads * 2)
        else:
            di, n, h = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
            total += d * (2 * di + 2 * n + h) + di * d
        if f:
            k = cfg.experts_per_token if spec.moe else 1
            total += 3 * d * f * k
            if spec.moe and cfg.shared_expert:
                total += 3 * d * f
    return float(total)
