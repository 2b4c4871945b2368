#!/usr/bin/env python3
"""Time the port's four boundary kernels of one source tree on the card.

  python3 tools/time_boundary_kernels.py [--src DIR] [--sweep] [--tag T]

Loads ``repro_torch`` from DIR (default: this checkout's ``src``), so an
older commit unpacked beside this one can be timed in the same call, in
turns (old, new, new, old).  Times K1-K4 and their plain versions with
``chip_smoke.py``'s method (CUDA graphs of back-to-back calls between
CUDA events, median) at serve's shape (1, 8, D, 16) for D = 2304, 768
and 4096 and at the large shape (8, 4096, 2304, 16), at 8 and 4 bits,
beside the bytes bound.  With ``--sweep`` (a tree whose quantize entry
point takes its launch shape): K3 at 1-8 warps a row, for 8 to 32768
rows of 2304, serve's rows and rows of 8192, each checked against the
wrapper's output first.  Prints one JSON object a line, and the card's
name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_WIDTHS = (2304, 768, 4096)
LARGE = (8, 4096, 2304, 16)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS  # the timing method and the bounds
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build as KB
    from repro_torch.kernels import boundary, ref, semantic_cache, uaq
    K = {"ref": ref, "boundary": boundary, "uaq": uaq,
         "semantic_cache": semantic_cache}
    KB.build()
    KB.lib()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    def emit(**kw):
        print(json.dumps(dict(tag=args.tag, src=args.src, **kw)), flush=True)

    shapes = [(1, 8, D, 16) for D in SERVE_WIDTHS] + [LARGE]
    for shape in shapes:
        big = shape == LARGE
        for bits in (8, 4):
            t = CS.time_kernels(torch, K, shape, inner=3 if big else 200,
                                outer=10 if big else 20, bits=bits)
            for name, r in t.items():
                emit(kernel=name, shape=list(shape), bits=bits, **r)
    if args.sweep:
        sweep(torch, CS, KB, uaq, emit)
    return 0


def sweep(torch, CS, KB, uaq, emit):
    gen = torch.Generator(device="cuda").manual_seed(11)
    lib = KB.lib()
    for (M, N) in ((8, 768), (8, 2304), (8, 4096), (256, 2304),
                   (1024, 2304), (4096, 2304), (32768, 2304), (2048, 8192)):
        for bits in (8, 4):
            x = torch.randn((M, N), generator=gen, device="cuda")
            want = uaq.uaq_quantize(x, bits)
            P = N * bits // 8
            p = torch.empty((M, P), dtype=torch.uint8, device="cuda")
            s = torch.empty((M, 1), device="cuda")
            z = torch.empty((M, 1), device="cuda")
            def call(w):
                KB.check(lib.coach_uaq_quantize(
                    x.data_ptr(), p.data_ptr(), s.data_ptr(), z.data_ptr(),
                    M, N, bits, w, 0, KB.stream_of(x)), "sweep")
            nbytes, ops = CS.work("uaq_quantize", 1, M, N, 16, bits)
            for w in (1, 2, 4, 8):
                if 32 * w * KB.LANE_CAP < N:
                    continue
                call(w)
                torch.cuda.synchronize()
                for g, h in zip((p, s, z), want):
                    assert torch.equal(g, h), ("K3 sweep differs", M, N, w)
                big = M * N > 1 << 22
                ms = CS.device_ms(torch, lambda: call(w),
                                  3 if big else 200, 10 if big else 20)
                emit(kernel="uaq_quantize", sweep=True, shape=[M, N],
                     bits=bits, warps=w, chosen=w == KB.quantize_warps(M, N),
                     ms=ms, bound_ms=nbytes / CS.HBM_BYTES_PER_S * 1e3)


if __name__ == "__main__":
    sys.exit(main())
