#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of COACH (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. build the Hopper kernels from ``src/repro_torch/kernels/csrc`` with
     nvcc for sm_90a and print ptxas' registers / shared memory / spills;
  2. hold every kernel against its plain PyTorch version on the card at
     the JAX package's test shapes, serve's shape, calibration's shape and
     a large shape: wire fields (payload, scale, zp, dequantized values)
     bit-equal, probe fields (feat, sims, sep) within TOL, ``best`` equal
     except at near-ties;
  3. time each kernel and its plain version (CUDA graphs of back-to-back
     launches, CUDA events, median) beside the bytes/operations bound;
  4. serve 24 requests on full-width gemma2-2b (random weights from a
     seed) through ``repro_torch.launch.serve.serve`` and require the
     fused boundary and dequantize kernels to have launched;
  5. on a runtime over the same weights, run the unfused hop (quantize +
     dequantize kernels) and the standalone probe (semantic-probe
     kernel), check the logits against the monolithic forward, time one
     steady request and profile where its device time goes;
  6. print the card's name and power limit, the kernels' JSON line, and
     the contract line.

Exits with code 2 and prints no result when CUDA is not available or
``src/repro_torch`` is not beside this script.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and fp32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 tolerance of the probe fields: GAP over up to 4096 rows and D-long
# dot products are summed in another order by the kernel than by torch
TOL = dict(atol=1e-5, rtol=1e-4)
CHECK_SHAPES = [  # (B, S, D, L): tests/test_boundary.py, serve, calib, large
    (2, 64, 32, 5), (3, 100, 33, 4), (1, 1, 16, 2),
    (1, 8, 2304, 16), (300, 8, 2304, 16), (8, 4096, 2304, 16)]
RAGGED_M = [(257, 2304), (1000, 33), (2399, 2304)]  # K2/K3 only
SERVE_SHAPE = (1, 8, 2304, 16)
LARGE_SHAPE = (8, 4096, 2304, 16)
CU_SOURCE = "src/repro_torch/kernels/csrc/coach_kernels.cu"
KERNEL_NAME = re.compile(r"[A-Za-z_]\w*_kernel")  # in a demangled name
REPLACES = {
    "fused_boundary": "src/repro/kernels/boundary.py:119",
    "uaq_dequantize": "src/repro/kernels/uaq.py:109",
    "uaq_quantize": "src/repro/kernels/uaq.py:77",
    "semantic_probe": "src/repro/kernels/semantic_cache.py:79",
}


def log(*a):
    print(*a, flush=True)


def close(a, b, atol, rtol):
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ------------------------------------------------------------ phase 2
def check_kernels(torch, K):
    """Every kernel against its plain version; returns max abs error per
    kernel (0 for the bit-equal wire fields)."""
    ref, B_, U, S_ = K["ref"], K["boundary"], K["uaq"], K["semantic_cache"]
    errs = {k: 0.0 for k in REPLACES}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (B, S, D, L) in CHECK_SHAPES:
        x = torch.randn((B, S, D), generator=gen, device="cuda") * 2.0 + 0.3
        c = torch.randn((L, D), generator=gen, device="cuda")
        for bits in (4, 8):
            got = B_.fused_boundary(x, c, bits)
            want = ref.fused_boundary_ref(x, c, bits)
            for name, g, w in zip(("payload", "scale", "zp"), got, want):
                assert torch.equal(g, w), \
                    f"fused_boundary {name} differs at {(B, S, D, L)} {bits}b"
            for name, g, w in zip(("feat", "sep", "sims"),
                                  (got[3], got[4], got[6]),
                                  (want[3], want[4], want[6])):
                assert close(g, w, **TOL), \
                    f"fused_boundary {name} err {max_err(g, w)} at " \
                    f"{(B, S, D, L)} {bits}b"
                errs["fused_boundary"] = max(errs["fused_boundary"],
                                             max_err(g, w))
            check_best(torch, got[5], want[5], want[6], "fused_boundary")
            # K3 + K2 on the same rows
            x2 = x.reshape(B * S, D)
            q = U.uaq_quantize(x2, bits)
            for name, g, w in zip(("payload", "scale", "zp"), q,
                                  ref.uaq_quantize_ref(x2, bits)):
                assert torch.equal(g, w), \
                    f"uaq_quantize {name} differs at {(B * S, D)} {bits}b"
                assert torch.equal(g, got[("payload", "scale", "zp").index(
                    name)].reshape(g.shape)), "K1 and K3 wire fields differ"
            d = U.uaq_dequantize(*q, bits, n=D)
            dw = ref.uaq_dequantize_ref(*q, bits, n=D)
            assert torch.equal(d, dw), f"uaq_dequantize differs at {(B * S, D)}"
        sep, best, sims = S_.semantic_probe(x, c)
        wsep, wbest, wsims = ref.semantic_probe_ref(x, c)
        for name, g, w in (("sep", sep, wsep), ("sims", sims, wsims)):
            assert close(g, w, **TOL), \
                f"semantic_probe {name} err {max_err(g, w)} at {(B, S, D, L)}"
            errs["semantic_probe"] = max(errs["semantic_probe"], max_err(g, w))
        check_best(torch, best, wbest, wsims, "semantic_probe")
        log(f"  ok {(B, S, D, L)}")
    for (M, N) in RAGGED_M:
        x2 = torch.randn((M, N), generator=gen, device="cuda")
        for bits in (4, 8):
            q = U.uaq_quantize(x2, bits)
            for g, w in zip(q, ref.uaq_quantize_ref(x2, bits)):
                assert torch.equal(g, w), f"uaq_quantize differs at {(M, N)}"
            assert torch.equal(U.uaq_dequantize(*q, bits, n=N),
                               ref.uaq_dequantize_ref(*q, bits, n=N)), \
                f"uaq_dequantize differs at {(M, N)}"
        log(f"  ok ragged M {(M, N)}")
    torch.cuda.synchronize()
    return errs


def check_best(torch, got, want, sims, name):
    """``best`` equal except where the plain version's top-2 gap is within
    the sims tolerance (a near-tie either side may win)."""
    top2 = torch.topk(sims, min(2, sims.shape[1]), dim=1).values
    gap = top2[:, 0] - top2[:, -1] if sims.shape[1] > 1 \
        else torch.full_like(top2[:, 0], math.inf)
    bad = (got != want) & (gap > TOL["atol"] + TOL["rtol"])
    assert not bool(bad.any()), f"{name}: best differs away from a near-tie"


# ------------------------------------------------------------ phase 3
def device_ms(torch, fn, inner, outer):
    """Median device time of one ``fn()``: ``inner`` calls captured in a
    CUDA graph (no host gaps between launches), replayed ``outer`` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(outer):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    ms = statistics.median(a.elapsed_time(b) for a, b in pairs) / inner
    del graph
    return ms


def work(name, B, S, D, L, bits):
    """(bytes moved, fp32 operations) of one call: each input read once,
    each output written once; ~7 operations per element for the quantize
    (min, max, divide, add, round, 2 clamps), 1 for the GAP add, 2 for
    dequantize, and 4 per center element for the probe's norms and dots."""
    n = B * S * D
    P = (D + 1) // 2 if bits == 4 else D
    wire = B * S * (P + 8)
    probe_out = B * (4 + 4 + 4 * L)
    probe_ops = 4 * L * D * B
    if name == "fused_boundary":
        return (4 * n + 4 * L * D + wire + 4 * B * D + probe_out,
                8 * n + probe_ops)
    if name == "uaq_quantize":
        return 4 * n + wire, 7 * n
    if name == "uaq_dequantize":
        return wire + 4 * n, 2 * n
    return 4 * n + 4 * L * D + probe_out, n + probe_ops  # semantic_probe


def time_kernels(torch, K, shape, inner, outer, bits=8):
    ref, B_, U, S_ = K["ref"], K["boundary"], K["uaq"], K["semantic_cache"]
    B, S, D, L = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((B, S, D), generator=gen, device="cuda")
    c = torch.randn((L, D), generator=gen, device="cuda")
    x2 = x.reshape(B * S, D)
    q = U.uaq_quantize(x2, bits)
    calls = {
        "fused_boundary": (lambda: B_.fused_boundary(x, c, bits),
                           lambda: ref.fused_boundary_ref(x, c, bits)),
        "uaq_dequantize": (lambda: U.uaq_dequantize(*q, bits, n=D),
                           lambda: ref.uaq_dequantize_ref(*q, bits, n=D)),
        "uaq_quantize": (lambda: U.uaq_quantize(x2, bits),
                         lambda: ref.uaq_quantize_ref(x2, bits)),
        "semantic_probe": (lambda: S_.semantic_probe(x, c),
                           lambda: ref.semantic_probe_ref(x, c)),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        nbytes, ops = work(name, B, S, D, L, bits)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        out[name] = {
            "ms": device_ms(torch, kern, inner, outer),
            "plain_ms": device_ms(torch, plain, inner, outer),
            "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / FP32_OPS_PER_S else "operations",
        }
        r = out[name]
        log(f"  {name:15s} {shape} {bits}b: kernel {r['ms'] * 1e3:9.2f} us"
            f"  plain {r['plain_ms'] * 1e3:9.2f} us  bound "
            f"{r['bound_ms'] * 1e3:8.3f} us ({r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound)")
    del q
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phases 4-5
def device_profile(torch, fn, n):
    """torch.profiler over ``n`` calls of ``fn``: the CUDA kernels as
    (name, launches per call, device ms per call), most time first, and
    the wall ms per call (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = [(e.key, e.count / n, dev_us(e) / 1e3 / n)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[2]), wall


def profile_requests(torch, request, n):
    """Device busy time per request and the top kernels by device time.
    Returns the busy ms per request, or None when the profiler saw no
    device time."""
    rows, wall = device_profile(torch, request, n)
    busy = sum(r[2] for r in rows)
    if busy <= 0:
        log("profile: no device time recorded (not measured)")
        return None
    log(f"profile ({n} requests, profiler on): device busy {busy:.3f} "
        f"ms/request of {wall:.3f} ms wall (idle share "
        f"{1 - busy / wall:.3f}); {sum(r[1] for r in rows):.0f} kernel "
        f"launches/request")
    for name, count, ms in rows[:8]:
        log(f"  {ms:8.3f} ms/request  x{count:6.1f}  {name[:90]}")
    return round(busy, 4)


def rel_err(torch, a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.core.collab import CollabRuntime
    from repro_torch.core.costs import (A6000_SERVER, JETSON_NX, WIFI_5GHZ,
                                        transformer_graph)
    from repro_torch.core.partitioner import coach_offline
    from repro_torch.kernels import _build as KB
    from repro_torch.kernels import boundary, ref, semantic_cache, uaq
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    K = {"ref": ref, "boundary": boundary, "uaq": uaq,
         "semantic_cache": semantic_cache}

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")

    log("== phase 1: build")
    t0 = time.time()
    KB.build(verbose=True)
    KB.lib()
    log(f"built in {time.time() - t0:.1f}s: {KB.library_path().name}")

    log("== phase 2: kernels against their plain versions")
    t0 = time.time()
    errs = check_kernels(torch, K)
    log(f"all kernels agree ({time.time() - t0:.1f}s); max abs err {errs}")

    log("== phase 3: timing (device time per call)")
    t_serve = time_kernels(torch, K, SERVE_SHAPE, inner=200, outer=20)
    t_serve4 = time_kernels(torch, K, SERVE_SHAPE, inner=200, outer=20, bits=4)
    t_large = time_kernels(torch, K, LARGE_SHAPE, inner=3, outer=10)
    # which of the two launches of K1 / K4 takes the time at serve's shape
    x = torch.randn(SERVE_SHAPE[:3], device="cuda")
    c = torch.randn((SERVE_SHAPE[3], SERVE_SHAPE[2]), device="cuda")
    for name, fn in (("fused_boundary", lambda: boundary.fused_boundary(
            x, c, 8)), ("semantic_probe",
                        lambda: semantic_cache.semantic_probe(x, c))):
        rows, _ = device_profile(torch, fn, 50)
        parts = [f"{KERNEL_NAME.search(n).group()} {ms * 1e3:.2f} us"
                 for n, _, ms in rows]
        log(f"  {name} at {SERVE_SHAPE}, per launch (profiler, eager): "
            + "; ".join(parts))

    log("== phase 4: serve 24 requests on full-width gemma2-2b")
    cfg = get_config("gemma2-2b")
    t0 = time.time()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"params: {M.param_count(params) / 1e9:.3f} B in "
        f"{time.time() - t0:.1f}s")
    requests = 24
    KB.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    stats = serve("gemma2-2b", smoke=False, requests=requests, device="cuda",
                  params=params)
    torch.cuda.synchronize()
    wall = time.time() - t0
    serve_launches = dict(KB.LAUNCHES)
    log(f"serve wall {wall:.3f}s incl. planner and 300-task calibration "
        f"({wall / requests * 1e3:.1f} ms/request upper bound); "
        f"launches {serve_launches}")
    for name in ("fused_boundary", "uaq_dequantize"):
        assert serve_launches.get(name, 0) > 0, f"serve never launched {name}"
    assert 0.0 <= stats.exit_ratio <= 1.0 and stats.mean_bits > 0, stats
    pr = stats.pipeline
    assert math.isfinite(pr.mean_latency) and pr.throughput > 0

    log("== phase 5: unfused hop and standalone probe on the same weights")
    off = coach_offline(transformer_graph(cfg, batch=1, seq=128), JETSON_NX,
                        A6000_SERVER, WIFI_5GHZ(50.0))
    n_end = sum(1 for i in off.decision.end_set if 0 < i <= cfg.num_layers)
    cut_group = min(max(1, round(n_end / cfg.group_size)),
                    cfg.num_groups - 1)
    rt = CollabRuntime(cfg, params, cut_group)
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, 8), generator=gen,
                         device="cuda", dtype=torch.int32)
    centers = torch.randn((16, cfg.d_model), generator=gen, device="cuda")
    with torch.no_grad():
        mono = rt.monolithic(params, toks)
        KB.LAUNCHES.clear()
        logits4, pkts = rt.run(toks, bits=(4,))
        logits8, _ = rt.run(toks, bits=(8,))
        _, h = rt.end_step(toks, bits=8)
        sep, best, sims = rt.probe(h, centers)
        torch.cuda.synchronize()
        second_launches = dict(KB.LAUNCHES)
        psep, pbest, psims = ref.semantic_probe_ref(h, centers)
    log(f"launches {second_launches}")
    for name in ("uaq_quantize", "uaq_dequantize", "semantic_probe"):
        assert second_launches.get(name, 0) > 0, \
            f"second phase never launched {name}"
    assert logits4.shape == (1, cfg.vocab_size), logits4.shape
    for lg in (mono, logits4, logits8):
        assert bool(torch.isfinite(lg).all()), "non-finite logits"
    r4, r8 = rel_err(torch, logits4, mono), rel_err(torch, logits8, mono)
    log(f"cut_group={cut_group} split vs monolithic rel err: "
        f"4b {r4:.4g} (< 0.25), 8b {r8:.4g} (< 0.02); wire bytes "
        f"{pkts[0].wire_bytes} vs fp32 {8 * cfg.d_model * 4}")
    assert r8 < 0.02 and r4 < 0.25, (r4, r8)
    assert close(sims, psims, **TOL) and close(sep, psep, **TOL)
    check_best(torch, best, pbest, psims, "probe")
    # one steady request on the serve path: fused end step + cloud step
    def request():
        pkt, _ = rt.end_step_fused(toks, centers)
        return rt.cloud_step(pkt)

    with torch.no_grad():
        for _ in range(3):
            request()
        torch.cuda.synchronize()
        per = []
        for _ in range(10):
            t0 = time.perf_counter()
            request()
            torch.cuda.synchronize()
            per.append(time.perf_counter() - t0)
    req_ms = statistics.median(per) * 1e3
    log(f"steady request (end segment + fused boundary + dequantize + "
        f"cloud segment + head): {req_ms:.2f} ms median of 10")
    busy_ms = profile_requests(torch, request, 3)

    assert "jax" not in sys.modules and "repro" not in sys.modules, \
        "the port imported JAX or the JAX package"

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    launches = {**serve_launches, **{k: v for k, v in second_launches.items()
                                     if k not in serve_launches}}
    kernels = []
    for name in REPLACES:
        s = t_serve[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": REPLACES[name], "launches": int(launches[name]),
            "max_abs_err": errs[name], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": None,
            "shape": list(SERVE_SHAPE), "bits": 8,
            "int4": {"ms": t_serve4[name]["ms"],
                     "plain_ms": t_serve4[name]["plain_ms"],
                     "bound_ms": t_serve4[name]["bound_ms"]},
            "large": dict(t_large[name], shape=list(LARGE_SHAPE), bits=8),
        })
    log(f"request_ms={req_ms:.4f} request_device_busy_ms={busy_ms} "
        f"serve_wall_s={wall:.4f}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
