#!/usr/bin/env python3
"""Time a mamba2 block's projections at few rows on the card: the
projection kernels (K6, ``kernels/ssd_proj.py``) against the plain
products and one cuBLAS product, and one whole block
(``models.ssm.mamba_forward``) with the kernels and without.

  python3 tools/time_ssd_proj.py [--rows 1,8,16] [--tag T]

At mamba2-130m's widths, fp32, TF32 off:
  * ``ssd_in_proj`` (768 -> 1536, 1536, 128, 128, 24) and ``ssd_out_proj``
    (1536 -> 768) at each number of rows, at the tile the widths choose:
    device us a call (``chip_smoke.time_ssd_proj``: calls captured in a
    CUDA graph, each on the next of 24 layers' weights so that they come
    from device memory, replayed between CUDA events, median) beside the
    bound of
    their weight bytes over 3.35 TB/s, the plain products' us and one
    cuBLAS product's;
  * one block at (1, rows) tokens on the projection kernels and on the
    plain products (the kernels' row limit set to 0), device us a call
    (each call on the next of 24 blocks' weights) and the largest
    difference of the two outputs over their largest value.
Checks each entry point against the products first
(``chip_smoke.check_ssd_proj``).  Prints the card's name and power limit,
then one JSON object a line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="1,8,16")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as CS  # the timing method, the checks and bounds
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build as KB
    from repro_torch.kernels import ssd_proj as PROJ
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

    emit(what="check", max_rel_err=CS.check_ssd_proj(torch, cfg))
    for rows in (int(r) for r in args.rows.split(",")):
        for name, r in CS.time_ssd_proj(torch, cfg, rows, 20).items():
            emit(what="call", call=name, rows=rows,
                 device_us=r["ms"] * 1e3, plain_us=r["plain_ms"] * 1e3,
                 library_us=r["library_ms"] * 1e3,
                 bound_us=r["bound_ms"] * 1e3, bound_by=r["bound_by"],
                 shape=r["shape"], bound_pct=100.0 * r["bound_ms"] / r["ms"])
        gen = torch.Generator(device="cuda").manual_seed(rows)
        ps = [SSM.init_mamba(cfg, gen, torch.float32, "cuda")
              for _ in range(cfg.num_layers)]
        p = ps[0]
        x = torch.randn((1, rows, cfg.d_model), generator=gen, device="cuda")
        turn = itertools.count()
        limit = PROJ.MAX_ROWS
        with torch.no_grad():
            layer = {}
            for path in ("fused", "plain"):
                PROJ.MAX_ROWS = limit if path == "fused" else 0
                try:
                    before = SSM.PROJ_PATHS.copy()
                    out = SSM.mamba_forward(p, x, cfg)
                    took = SSM.PROJ_PATHS.copy()
                    took.subtract(before)
                    us = CS.device_ms(torch, lambda: SSM.mamba_forward(
                        ps[next(turn) % len(ps)], x, cfg),
                        2 * len(ps), 20) * 1e3
                finally:
                    PROJ.MAX_ROWS = limit
                layer[path] = out
                emit(what="block", path=path, rows=rows, device_us=us,
                     proj_paths={k: v for k, v in took.items() if v})
            emit(what="block_diff", rows=rows,
                 max_rel=CS.max_err(layer["fused"], layer["plain"])
                 / float(layer["plain"].abs().max()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
