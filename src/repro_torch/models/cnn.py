"""ResNet101 / VGG16 layer-cost DAG builders — the paper's evaluation models.

These produce ``ModelGraph``s with analytically derived per-layer FLOPs and
activation sizes (batch=1 inference task, 224x224x3 input).  ResNet101's
bottleneck blocks carry real skip-edge DAG structure, exercising the
virtual-block clustering of Algorithm 1; VGG16 is the chain-topology case.
"""

from __future__ import annotations

from typing import List

from repro_torch.core.costs import LayerNode, ModelGraph


def _conv_flops(h, w, cin, cout, k, stride=1):
    ho, wo = h // stride, w // stride
    return 2.0 * ho * wo * cin * cout * k * k, ho, wo


def _sens(depth_frac: float) -> float:
    """Per-layer quantization sensitivity: early layers carry raw-signal
    detail and need more bits (§II-B spatial-locality observation)."""
    return 0.04 * (1.0 - 0.75 * depth_frac)


VGG_CONV_UTIL = 0.6   # dense 3x3 stacks (TensorRT-class; keeps VGG link-bound like the paper)
VGG_FC_UTIL = 0.1     # fc layers: memory bound
RESNET_UTIL = 0.11    # 1x1-dominated bottlenecks: memory bound end-to-end


def vgg16(input_hw: int = 224) -> ModelGraph:
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    nodes: List[LayerNode] = []
    h = w = input_hw
    cin, nid = 3, 0
    n_layers = sum(1 for c in cfg if c != "M") + 3
    for i, c in enumerate(cfg):
        if c == "M":
            h, w = h // 2, w // 2
            continue
        fl, ho, wo = _conv_flops(h, w, cin, c, 3)
        # a partition point after this conv transfers the *pooled* tensor
        # when a maxpool follows (the natural cut sits after pooling)
        pooled = (i + 1 < len(cfg) and cfg[i + 1] == "M")
        oe = (ho // 2) * (wo // 2) * c if pooled else ho * wo * c
        nodes.append(LayerNode(nid, f"conv{nid}", fl, oe,
                               (nid - 1,) if nid else (),
                               sensitivity=_sens(nid / n_layers),
                               util=VGG_CONV_UTIL))
        cin, h, w, nid = c, ho, wo, nid + 1
    feat = h * w * cin
    for i, f in enumerate([4096, 4096, 1000]):
        nodes.append(LayerNode(nid, f"fc{i}", 2.0 * feat * f, f, (nid - 1,),
                               sensitivity=_sens(nid / n_layers),
                               util=VGG_FC_UTIL))
        feat, nid = f, nid + 1
    return ModelGraph("vgg16", nodes, input_elems=input_hw * input_hw * 3)


def resnet101(input_hw: int = 224) -> ModelGraph:
    nodes: List[LayerNode] = []
    nid = 0
    stages = [(3, 64, 256, 1), (4, 128, 512, 2), (23, 256, 1024, 2),
              (3, 512, 2048, 2)]
    total_blocks = sum(s[0] for s in stages)

    def add(name, flops, out_elems, deps, frac):
        nonlocal nid
        nodes.append(LayerNode(nid, name, flops, int(out_elems), tuple(deps),
                               sensitivity=_sens(frac), util=RESNET_UTIL))
        nid += 1
        return nid - 1

    h = w = input_hw // 2  # conv1 stride 2
    fl, h, w = _conv_flops(input_hw, input_hw, 3, 64, 7, 2)
    prev = add("conv1", fl, h * w * 64, (), 0.0)
    h, w = h // 2, w // 2  # maxpool
    cin = 64
    done = 0
    for (blocks, mid, cout, stride) in stages:
        for b in range(blocks):
            frac = done / total_blocks
            done += 1
            s = stride if b == 0 else 1
            entry = prev
            f1, h1, w1 = _conv_flops(h, w, cin, mid, 1, s)
            c1 = add(f"c{done}a", f1, h1 * w1 * mid, (entry,), frac)
            f2, _, _ = _conv_flops(h1, w1, mid, mid, 3)
            c2 = add(f"c{done}b", f2, h1 * w1 * mid, (c1,), frac)
            f3, _, _ = _conv_flops(h1, w1, mid, cout, 1)
            c3 = add(f"c{done}c", f3, h1 * w1 * cout, (c2,), frac)
            if b == 0:  # projection shortcut branch
                fp, _, _ = _conv_flops(h, w, cin, cout, 1, s)
                proj = add(f"c{done}p", fp, h1 * w1 * cout, (entry,), frac)
                skip_dep = proj
            else:  # identity skip edge (entry -> add)
                skip_dep = entry
            prev = add(f"add{done}", h1 * w1 * cout * 2.0, h1 * w1 * cout,
                       (c3, skip_dep), frac)
            h, w, cin = h1, w1, cout
    add("fc", 2.0 * cin * 1000, 1000, (prev,), 1.0)
    return ModelGraph("resnet101", nodes, input_elems=input_hw * input_hw * 3)
