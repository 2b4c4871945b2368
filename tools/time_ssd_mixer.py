#!/usr/bin/env python3
"""Time one mamba2 layer's SSD mixer on the card: the plain chain against
the fused kernels (K5, ``kernels/ssd.py``), and count a mamba2 task's
graph nodes with and without them.

  python3 tools/time_ssd_mixer.py [--tag T]

At mamba2-130m's widths, with the inputs the projections give at (1, 8,
768) and (1, 128, 768), fp32:
  * the plain chain (``models.ssm.mixer_plain``) and the fused launches
    (``kernels.ssd.ssd_mixer``), each checked against the other first:
    device us a call (``chip_smoke.device_ms``: calls captured in a CUDA
    graph, replayed between CUDA events, median) and kernel nodes a call,
    beside the mixer's bound (``chip_smoke.ssd_work``: its own inputs and
    outputs over 3.35 TB/s or its fp32 operations over 67 TFLOP/s, the
    larger) and the share of it a call reaches;
  * a breakdown by kernel: each fused kernel's device us a call
    (torch.profiler) beside the bound of that launch alone, whose bytes
    include the fp32 workspaces the launches hand on to each other (so
    its shares are no roofline of the mixer); the state kernel as a
    prefill with ``return_cache`` runs it;
  * a served mamba2-130m task (the fused end step and the cloud step of
    a runtime at the planner's cut, the bare segment functions captured
    whole): kernel nodes with the fused mixer and with the plain chain.
Prints the card's name and power limit, then one JSON object a line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, 8), (1, 128))
KERNELS = ("ssd_prep", "ssd_chunk", "ssd_state", "gated_rmsnorm")


def launch_work(name, cfg, B, S):
    """(bytes, fp32 operations) of one launch of kernel ``name`` over B
    rows of S tokens of the fp32 block ``cfg``, the workspaces it reads
    and writes included."""
    di, N, H, P, K = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_head_dim, cfg.ssm_conv)
    Q = min(cfg.ssm_chunk, S)
    nc = -(-S // Q)
    Sp = nc * Q
    C = di + 2 * N  # the conv's channels
    pairs = nc * Q * (Q + 1) // 2  # (i, j) with j <= i, a row and chunk
    if name == "ssd_prep":  # the convs, dt's scan and C.B^T (i >= j)
        nbytes = 4 * (B * S * (C + H) + (K + 1) * C + 2 * H
                      + B * Sp * (C + 2 * H) + B * pairs)
        ops = B * S * (2 * K * C + 4 * C + 4 * H) + B * Sp * H * 2 \
            + B * pairs * 2 * N
    elif name == "ssd_chunk":  # the decay, (CB o L) . (x dt), the D skip
        nbytes = 4 * (B * Sp * (di + 2 * H) + B * pairs + H + B * S * di)
        ops = B * pairs * H * (3 + 2 * P) + 3 * B * S * di
    elif name == "ssd_state":
        nbytes = 4 * (B * Sp * (di + 2 * N + 2 * H) + 2 * B * S * di
                      + B * H * P * N)
        ops = B * nc * H * P * N * (2 * Q + 2) \
            + (B * (nc - 1) * Q * H * P * (2 * N + 2) if nc > 1 else 0)
    else:  # gated_rmsnorm
        nbytes = 4 * (3 * B * S * di + di)
        ops = B * S * di * 8
    return nbytes, ops


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as CS  # the timing method, node counts and bounds
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build as KB
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import ssm as SSM
    KB.build()
    KB.lib()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2-130m")

    def emit(**kw):
        print(json.dumps(dict(tag=args.tag, card=smi, **kw)), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(3)
    p = SSM.init_mamba(cfg, torch.Generator(device="cuda").manual_seed(0),
                       torch.float32, "cuda")
    with torch.no_grad():
        for B, S in SHAPES:
            x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
            acts = tuple(x @ p[k] for k in ("in_z", "in_x", "in_B", "in_C",
                                            "in_dt"))
            calls = {
                "plain": lambda: SSM.mixer_plain(p, *acts, cfg),
                "fused": lambda: SSD.ssd_mixer(*acts, p, chunk=cfg.ssm_chunk,
                                               eps=cfg.norm_eps),
                "fused_state": lambda: SSD.ssd_mixer(
                    *acts, p, chunk=cfg.ssm_chunk, eps=cfg.norm_eps,
                    want_state=True)}
            want, whT = calls["plain"]()
            for name in ("fused", "fused_state"):
                got, hT = calls[name]()
                err = float((got - want).abs().max())
                assert err <= 1e-4 * max(1.0, float(want.abs().max())), \
                    (name, err)
                if hT is not None:
                    herr = float((hT - whT).abs().max())
                    assert herr <= 1e-4 * float(whT.abs().max()), (name, herr)
            for name, fn in calls.items():
                us = CS.device_ms(torch, fn, 50, 20) * 1e3
                nodes = sum(1 for t in CS.graph_node_types(torch, fn)
                            if t == 0)
                nbytes, ops = CS.ssd_work(cfg, B, S,
                                          state=name == "fused_state")
                bound_us = max(nbytes / CS.HBM_BYTES_PER_S,
                               ops / CS.FP32_OPS_PER_S) * 1e6
                emit(what="layer", call=name, shape=[B, S, cfg.d_model],
                     device_us=us, kernel_nodes=nodes, bytes=nbytes,
                     ops=ops, bound_us=bound_us,
                     roofline_pct=100.0 * bound_us / us)
            for name in ("fused", "fused_state"):
                rows, _ = CS.device_profile(torch, calls[name], 50)
                for kernel in KERNELS:
                    hit = [r for r in rows if kernel + "_kernel" in r[0]]
                    if not hit:
                        continue
                    nbytes, ops = launch_work(kernel, cfg, B, S)
                    bound_us = max(nbytes / CS.HBM_BYTES_PER_S,
                                   ops / CS.FP32_OPS_PER_S) * 1e6
                    us = sum(r[2] for r in hit) * 1e3
                    emit(what="kernel", call=name, kernel=kernel,
                         shape=[B, S, cfg.d_model], device_us=us,
                         launches=sum(r[1] for r in hit),
                         bytes_with_workspace=nbytes, ops=ops,
                         launch_bound_us=bound_us,
                         bound_by="bytes" if nbytes / CS.HBM_BYTES_PER_S
                         >= ops / CS.FP32_OPS_PER_S else "ops",
                         launch_bound_pct=100.0 * bound_us / us)
    task_nodes(torch, CS, cfg, SSM, emit)
    return 0


def task_nodes(torch, CS, cfg, SSM, emit):
    """Kernel nodes of one served mamba2-130m task (end step with the
    fused boundary, then the cloud step) captured whole, with the fused
    mixer and with the plain chain (the device test made to fail)."""
    from repro_torch.core.collab import CollabRuntime
    from repro_torch.core.costs import (A6000_SERVER, JETSON_NX, WIFI_5GHZ,
                                        transformer_graph)
    from repro_torch.core.partitioner import coach_offline
    from repro_torch.models import model as M
    params = CS.init_params(torch, M, cfg)
    off = coach_offline(transformer_graph(cfg, batch=1, seq=128), JETSON_NX,
                        A6000_SERVER, WIFI_5GHZ(50.0))
    n_end = sum(1 for i in off.decision.end_set if 0 < i <= cfg.num_layers)
    cut = min(max(1, round(n_end / cfg.group_size)), cfg.num_groups - 1)
    rt = CS.eager_twin(CollabRuntime(cfg, params, cut))
    gen = torch.Generator(device="cuda").manual_seed(2)
    centers = torch.randn((16, cfg.d_model), generator=gen, device="cuda")
    on_card = SSM._on_card
    for S in (8, 128):
        toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                             device="cuda", dtype=torch.int32)

        def request():
            pkt, _ = rt.end_step_fused(toks, centers)
            return rt.cloud_step(pkt)

        counts = {}
        for path in ("fused", "plain"):
            SSM._on_card = on_card if path == "fused" else (lambda t: False)
            try:
                before = SSM.PATHS.copy()
                with torch.no_grad():
                    request()
                    torch.cuda.synchronize()
                    counts[path] = sum(
                        1 for t in CS.graph_node_types(torch, request)
                        if t == 0)
                took = SSM.PATHS.copy()
                took.subtract(before)
            finally:
                SSM._on_card = on_card
            emit(what="task", path=path, tokens=S, cut_group=cut,
                 kernel_nodes=counts[path],
                 mixer_calls={k: v for k, v in took.items() if v})


if __name__ == "__main__":
    sys.exit(main())
