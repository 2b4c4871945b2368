"""Cost substrate for the COACH offline component.

A model is a ``ModelGraph`` of ``LayerNode``s (DAG; chain is the special
case).  Device/link profiles turn FLOPs/bytes into stage times — exactly the
role of the paper's system-profile measurement step (§III-B, Alg. 1 line 2).

Profiles include the paper's own testbed (Jetson NX / TX2 + A6000 server,
WiFi link) and the TPU-adaptation profiles used by the collaborative
executor (pod-of-v5e as "end", pod as "cloud", ICI/DCN link).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    flops_per_s: float
    efficiency: float = 1.0  # device-level attainable fraction

    def layer_time(self, flops: float, util: float = 1.0) -> float:
        """``util`` is the per-layer attainable fraction (profiled): dense
        3x3 convs hit ~0.8 of effective peak on a Jetson, 1x1-conv/memory-
        bound residual layers ~0.1 — an order of magnitude apart, which is
        what makes the paper's VGG/ResNet latencies non-proportional to
        their FLOPs."""
        return flops / (self.flops_per_s * self.efficiency * util)


@dataclasses.dataclass
class LinkProfile:
    """Transmission link.  ``bandwidth`` in bits/s; can be a trace function
    of absolute time for dynamic-network experiments."""

    name: str
    bandwidth_bps: float
    trace: Optional[Callable[[float], float]] = None  # t -> bps

    def bps_at(self, t: float) -> float:
        return self.trace(t) if self.trace is not None else self.bandwidth_bps

    def transfer_time(self, bits: float, start: float = 0.0) -> float:
        """Time to push ``bits`` starting at ``start`` (integrates a
        piecewise-constant trace with 1 ms resolution)."""
        if self.trace is None:
            return bits / self.bandwidth_bps
        t, left, dt = start, bits, 1e-3
        while left > 0:
            bw = max(self.bps_at(t), 1.0)
            sent = bw * dt
            if sent >= left:
                return (t - start) + left / bw
            left -= sent
            t += dt
        return t - start


# ------------------------------------------------------------------ profiles
# Paper testbed (Table I setting): Jetson Xavier NX / TX2 ends, A6000 cloud.
# flops_per_s = dense-kernel effective peak (TensorRT-class); per-LAYER
# attainment enters through LayerNode.util, profiled per layer kind.
JETSON_NX = DeviceProfile("jetson-nx", 3.5e12)
JETSON_TX2 = DeviceProfile("jetson-tx2", 2.0e12)
# per-stream effective cloud throughput (the server is shared by many end
# devices; Fig. 2 shows cloud stage times comparable to the end stage)
A6000_SERVER = DeviceProfile("a6000", 25e12)
WIFI_5GHZ = lambda mbps=100.0: LinkProfile("wifi", mbps * 1e6)

# Mid-tier edge server for end->edge->cloud (3-hop) scenarios: an AGX-Orin
# class box between the Jetson ends and the A6000 cloud, reached over WiFi
# and wired to the cloud over metro ethernet.
EDGE_AGX_ORIN = DeviceProfile("agx-orin", 10e12)
ETH_LAN = lambda mbps=940.0: LinkProfile("eth-lan", mbps * 1e6)

# TPU adaptation: a v5e slice as the weak "end", a pod as the "cloud".
TPU_V5E_CHIP = DeviceProfile("v5e-chip", 197e12, efficiency=0.5)
TPU_POD_256 = DeviceProfile("v5e-pod", 197e12 * 256, efficiency=0.4)
ICI_LINK = lambda gbps=400.0: LinkProfile("ici", gbps * 1e9)


# ------------------------------------------------------------------- graph
@dataclasses.dataclass
class LayerNode:
    id: int
    name: str
    flops: float             # forward FLOPs for the whole (batched) task
    out_elems: int           # elements of the output activation
    deps: Tuple[int, ...] = ()
    # per-layer quantization sensitivity: acc_loss ~= sensitivity * 2^-(bits-2)
    sensitivity: float = 0.02
    # attainable compute fraction for this layer (profiled; see DeviceProfile)
    util: float = 1.0

    def out_bits(self, bits: int) -> float:
        return float(self.out_elems) * bits


class ModelGraph:
    """DAG of layers, ids topologically ordered (deps have smaller ids)."""

    def __init__(self, name: str, nodes: Sequence[LayerNode],
                 input_elems: Optional[int] = None):
        self.name = name
        self.nodes: List[LayerNode] = list(nodes)
        # raw model input size (uint8 image / token ids); defaults to the
        # first node's output as a proxy
        self.input_elems = int(input_elems if input_elems is not None
                               else (nodes[0].out_elems if nodes else 0))
        for n in self.nodes:
            assert all(d < n.id for d in n.deps), f"non-topological dep at {n.id}"
        self._children: Dict[int, List[int]] = {n.id: [] for n in self.nodes}
        for n in self.nodes:
            for d in n.deps:
                self._children[d].append(n.id)

    def __len__(self):
        return len(self.nodes)

    def children(self, i: int) -> List[int]:
        return self._children[i]

    def node(self, i: int) -> LayerNode:
        return self.nodes[i]

    @property
    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes)

    def is_chain(self) -> bool:
        return all(len(n.deps) <= 1 and len(self._children[n.id]) <= 1
                   for n in self.nodes)

    # -------------------------------------------------- partition semantics
    def boundary_edges(self, end_set: frozenset) -> List[Tuple[int, int]]:
        """Edges (u -> v) with u on the end device and v on the cloud.
        These carry the intermediate tensors of the partition layer set V_p."""
        out = []
        for n in self.nodes:
            if n.id in end_set:
                continue
            for d in n.deps:
                if d in end_set:
                    out.append((d, n.id))
        # model input consumed by a cloud node with no end parents: the raw
        # input is on the end device, so id -1 (input) edges appear when the
        # first node is on the cloud.
        for n in self.nodes:
            if n.id not in end_set and not n.deps:
                out.append((-1, n.id))
        return out

    def valid_end_set(self, end_set: frozenset) -> bool:
        """V_e must be downward-closed (no cloud->end dependency)."""
        return all(all(d in end_set for d in self.nodes[i].deps)
                   for i in end_set)


def segment_batch_split(device: DeviceProfile,
                        nodes: Sequence[LayerNode]
                        ) -> Tuple[float, float]:
    """Per-segment ``(t_fixed, t_marginal)`` for continuous micro-batching.

    A layer's profiled service time ``layer_time(flops, util)`` exceeds
    its compute-bound floor ``layer_time(flops, 1.0)`` by the attainment
    gap — for memory-bound layers (``util << 1``) that gap is weight /
    activation streaming and kernel-launch overhead, which a batched
    launch pays once, not per sample.  So the batchable decomposition of
    a segment is ``fixed = sum(gap)``, ``marginal = sum(compute floor)``;
    by construction ``fixed + marginal`` equals the segment's unbatched
    service time exactly, which is what keeps singleton batches
    bit-identical to the unbatched pipeline (``sim.batched_service_time``).
    """
    fixed = 0.0
    marginal = 0.0
    for n in nodes:
        floor = device.layer_time(n.flops, 1.0)
        fixed += device.layer_time(n.flops, n.util) - floor
        marginal += floor
    return fixed, marginal


def chain_graph(name: str, flops: Sequence[float], out_elems: Sequence[int],
                sensitivities: Optional[Sequence[float]] = None) -> ModelGraph:
    sens = sensitivities or [0.02] * len(flops)
    nodes = [LayerNode(i, f"l{i}", f, int(o), (i - 1,) if i else (),
                       sensitivity=s)
             for i, (f, o, s) in enumerate(zip(flops, out_elems, sens))]
    return ModelGraph(name, nodes)


def transformer_graph(cfg, batch: int, seq: int) -> ModelGraph:
    """Export an assigned architecture as a layer-cost chain for the COACH
    offline component (one node per transformer/ssm block + embed + head)."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    tok = batch * seq
    nodes: List[LayerNode] = []
    nid = 0

    def add(name, flops, out_elems, dep_prev=True):
        nonlocal nid
        deps = (nid - 1,) if (dep_prev and nid > 0) else ()
        nodes.append(LayerNode(nid, name, flops, int(out_elems), deps,
                               util=0.45))
        nid += 1

    add("embed", 0.0, tok * d)
    for li in range(cfg.num_layers):
        spec = cfg.pattern[li % len(cfg.pattern)]
        if spec.mixer == "attn":
            hd, H, KV = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
            qkvo = 2 * tok * d * (H * hd + 2 * KV * hd + H * hd)
            if spec.attn_kind == "local":
                ctx = min(seq, cfg.sliding_window)
            elif spec.attn_kind == "chunked":
                ctx = min(seq, cfg.attn_chunk)
            else:
                ctx = seq
            attn = 2 * 2 * batch * H * seq * ctx * hd  # qk + av
            mix = qkvo + attn
        else:
            di, N = cfg.ssm_inner, cfg.ssm_state
            proj = 2 * tok * d * (2 * di + 2 * N + cfg.ssm_heads) + 2 * tok * di * d
            ssd = 2 * tok * di * N * 2  # state update + readout
            mix = proj + ssd
        if cfg.d_ff > 0:
            k = cfg.experts_per_token if spec.moe else 1
            ffn = 2 * tok * 3 * d * f * k
            if spec.moe and cfg.shared_expert:
                ffn += 2 * tok * 3 * d * f
        else:
            ffn = 0
        add(f"block{li}", mix + ffn, tok * d)
    add("head", 2 * tok * d * V, tok * V)
    return ModelGraph(cfg.name, nodes, input_elems=tok * 4)  # int32 token ids
