#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of COACH (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. build the Hopper kernels from ``src/repro_torch/kernels/csrc`` with
     nvcc for sm_90a and print ptxas' registers / shared memory / spills;
  2. hold every kernel against its plain PyTorch version on the card at
     the JAX package's test shapes, serve's shape, calibration's shape and
     a large shape, with float32, bfloat16 and float16 activations (and
     dequantized values of the same type): wire fields (payload, scale,
     zp, dequantized values) bit-equal, probe fields (feat, sims, sep)
     within TOL, ``best`` equal except at near-ties; the quantize and the
     fused boundary on rows holding -0.0 / +0.0 and NaN, and the fused
     boundary and the probe with a NaN center or a NaN token, against
     their plain versions (NaN where they have NaN, ``best`` as
     torch.argmax takes it); the fused boundary, quantize and probe
     kernels' outputs bit-equal across two
     calls, after 50 replays of a captured call (the fused kernel's
     arrival counters go back to 0), and when two graphs captured on one
     stream are replayed out of order and at once;
  3. time each kernel and its plain version at 8 and 4 bits (CUDA graphs
     of back-to-back launches, CUDA events, median) beside the
     bytes/operations bound, at serve's shape on gemma2-2b, mamba2-130m
     and mixtral-8x7b widths and at a large shape, and require one kernel
     launch per call of the fused boundary, quantize and probe (one
     kernel node in a graph captured from a call, beside what the fused
     boundary's counters add there, and no other kernel under the
     profiler);
  4. serve 24 requests on full-width gemma2-2b (random weights from a
     seed) through ``repro_torch.launch.serve.serve`` and require the
     fused boundary and dequantize kernels to have launched;
  5. on a runtime over the same weights, run the unfused hop (quantize +
     dequantize kernels) and the standalone probe (semantic-probe
     kernel), check the logits against the monolithic forward, time one
     steady request, profile where its device time goes, and diff the
     kernel-name histograms of two more profiles of it;
  6. phases 4 and 5 on full-width mamba2-130m (24 layers);
  7. phases 4 and 5 on full-width mixtral-8x7b cut to 4 of its 32 layers
     (the 32 take ~187 GB in fp32, more than one card holds);
  8. greedy ``generate`` of 32 tokens after a 64-token prompt on that
     mixtral (dropless), full-width gemma2-2b and mamba2-130m: every token
     the forward's argmax (or a near-tie), decode ms/token beside the
     weight-bytes bound;
  9. the three-tier end -> edge -> cloud path of ``examples/edge_tier.py``
     on full-width mamba2-130m (the planner's cuts 3 and 12 of 24 groups,
     4-bit hops): sync and async engines whose ``classify`` runs
     ``rt.run`` (quantize and dequantize kernels at every hop), the
     executor running the runtime's fused segment handles (fused boundary
     kernel) and two tenants under wdrr, 24 requests each, with equal
     decisions across engines and against each tenant's solo run; every
     hop bit-equal to the plain versions, the (8, 8)-bit split within
     0.05 of the monolithic forward, and one steady request timed and
     profiled; then the engines on full-width gemma2-2b at its 6-bit plan
     (no kernel there: 6-bit hops run the plain versions);
  10. the two-pod pipeline (``make_collab_pipeline_step``, 8 bits) on
     full-width qwen3-14b in bf16, the pods on two CUDA streams, at the
     reference test's (2, 4, 32) tokens and at (8, 4, 256): the quantize
     and dequantize kernels once a microbatch, the output bit-equal to the
     pods serialized on one stream and to the plain versions' run, each
     microbatch within 0.05 of the monolithic forward, one step timed
     with the overlap and serialized;
  11. training: one step's loss and gradients on the card against the CPU
     (gemma2-2b at full width cut to 4 layers, full-width mamba2-130m), a
     checkpoint round trip of the stepped params and AdamW state on the
     card, and ``launch.train.train`` on full-width gemma2-2b (fp32, 5
     steps of 8 x 256 tokens): ms per step, tokens per second, peak
     memory and the fp32 bound;
  12. the launch tooling on DTensor: (a) on the 1x1 card mesh (a one-rank
     NCCL group), full-width gemma2-2b's prefill and 8 decode steps with
     the parameters as DTensors in the serving layout and the activation
     constraints live, bit-equal to the same steps on plain tensors (the
     ms of a decode step with and without DTensor), and a train step of
     the 4-layer gemma2-2b in the FSDP layout: loss bit-equal, gradients
     within 1e-6; (b) in a subprocess, the dry-run of gemma2-2b train_4k
     and mixtral-8x7b decode_32k on the 16x16 mesh of a fake 256-rank
     group: per device flops, HBM and collective bytes, roofline terms;
     (c) beside (b), in a subprocess, ``tools/dtensor_probe.py``: the
     reduced train steps of jamba, llama4, mamba2, mixtral and qwen3 (B,
     S = 4, 32, two microbatches of 2 rows, which do not divide the
     4-way data axis) on meta DTensors over the 4x4 CUDA mesh of a fake
     16-rank group, hooks live: each step runs;
  then print each phase's numbers, the card's name and power limit, the
  kernels' JSON line (launches summed over phases 4-7's, 9's and 10's
  main-path runs), and the contract line.

Exits with code 2 and prints no result when CUDA is not available or
``src/repro_torch`` is not beside this script.
"""

from __future__ import annotations

import dataclasses
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
# a generated token may differ from the forward's argmax only where the
# forward's top-2 logits are this close, relative to the row's largest
# |logit| (decode and forward run fp32 GEMMs of other shapes)
GEN_TIE_RTOL = 1e-3
# split vs monolithic logits (relative L2 error) by bit width: phase 5's
# bounds on gemma2-2b, and for phases 6-7 the 8-bit bound scaled by the
# quantum ratio 255/15 at 4 bits.  The logits' error grows with the
# quantum (4b/8b error ratio 15.9-17.1 on gemma2-2b and mamba2-130m), and
# how far it grows per unit of boundary error is the model's: with random
# weights mamba2-130m moves its logits ~2.5x the boundary's relative
# error, gemma2-2b ~1.3x (the equal-noise line of each runtime check)
SPLIT_BOUND = {8: 0.02, 4: 0.25}
SPLIT_BOUND_SCALED = {8: 0.02, 4: 0.02 * 255 / 15}
CHECK_SHAPES = [  # (B, S, D, L): tests/test_boundary.py, serve, calib, large,
    # and serve on mamba2-130m (D = 768) and mixtral-8x7b (D = 4096, rows in
    # groups of 2 warps)
    (2, 64, 32, 5), (3, 100, 33, 4), (1, 1, 16, 2),
    (1, 8, 2304, 16), (300, 8, 2304, 16), (8, 4096, 2304, 16),
    (1, 8, 768, 16), (1, 8, 4096, 16)]
RAGGED_M = [(257, 2304), (1000, 33), (2399, 2304)]  # K2/K3 only
DTYPES = ("float32", "bfloat16", "float16")  # activations, dequant output
SERVE_SHAPE = (1, 8, 2304, 16)
LARGE_SHAPE = (8, 4096, 2304, 16)
CSRC = "src/repro_torch/kernels/csrc"
SOURCES = {  # where each kernel's device code is
    "fused_boundary": f"{CSRC}/row_pass.cuh",
    "uaq_dequantize": f"{CSRC}/coach_kernels.cu",
    "uaq_quantize": f"{CSRC}/uaq_quantize.cu",
    "semantic_probe": f"{CSRC}/semantic_probe.cu",
}
KERNEL_NAME = re.compile(r"[A-Za-z_]\w*_kernel")  # in a demangled name
# the three-tier split at (8, 8) bits: max|d| / max|ref| against the
# monolithic forward, the bound and measure of tests/test_multihop.py:78
THREE_TIER_BOUND = 0.05
REPLACES = {
    "fused_boundary": "src/repro/kernels/boundary.py:119",
    "uaq_dequantize": "src/repro/kernels/uaq.py:109",
    "uaq_quantize": "src/repro/kernels/uaq.py:77",
    "semantic_probe": "src/repro/kernels/semantic_cache.py:79",
}


def log(*a):
    print(*a, flush=True)


def group_cuts_from_frontiers(decision, cfg):
    """Map the layer-level multi-cut onto strictly increasing group
    boundaries of the stacked parameters (embed node is id 0); the
    mapping of ``examples/edge_tier.py``, which imports JAX."""
    cuts = []
    lo = 1
    for k, frontier in enumerate(decision.cuts):
        n_layers = sum(1 for i in frontier if 0 < i <= cfg.num_layers)
        hi = cfg.num_groups - (decision.n_hops - k)
        cut = min(max(lo, round(n_layers / cfg.group_size)), hi)
        cuts.append(cut)
        lo = cut + 1
    return tuple(cuts)


def close(a, b, atol, rtol):
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ------------------------------------------------------------ phase 2
def check_kernels(torch, K):
    """Every kernel against its plain version, in every activation dtype;
    returns max abs error per kernel (0 for the bit-equal wire fields)."""
    ref, B_, U, S_ = K["ref"], K["boundary"], K["uaq"], K["semantic_cache"]
    errs = {k: 0.0 for k in REPLACES}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def near(name, kernel, g, w, where):
        assert close(g, w, **TOL), \
            f"{kernel} {name} err {max_err(g, w)} at {where}"
        errs[kernel] = max(errs[kernel], max_err(g, w))

    for (B, S, D, L) in CHECK_SHAPES:
        x32 = torch.randn((B, S, D), generator=gen, device="cuda") * 2.0 + 0.3
        c = torch.randn((L, D), generator=gen, device="cuda")
        for dt in DTYPES:
            dtype = getattr(torch, dt)
            x = x32.to(dtype)
            where = f"{(B, S, D, L)} {dt}"
            for bits in (4, 8):
                got = B_.fused_boundary(x, c, bits)
                want = ref.fused_boundary_ref(x, c, bits)
                for name, g, w in zip(("payload", "scale", "zp"), got, want):
                    assert torch.equal(g, w), \
                        f"fused_boundary {name} differs at {where} {bits}b"
                for i, name in ((3, "feat"), (4, "sep"), (6, "sims")):
                    near(name, "fused_boundary", got[i], want[i], where)
                check_best(torch, got[5], want[5], want[6], "fused_boundary")
                # K3 + K2 on the same rows
                x2 = x.reshape(B * S, D)
                q = U.uaq_quantize(x2, bits)
                for name, g, w in zip(("payload", "scale", "zp"), q,
                                      ref.uaq_quantize_ref(x2, bits)):
                    assert torch.equal(g, w), \
                        f"uaq_quantize {name} differs at {where} {bits}b"
                    assert torch.equal(g, got[("payload", "scale", "zp")
                                              .index(name)].reshape(g.shape)), \
                        "K1 and K3 wire fields differ"
                d = U.uaq_dequantize(*q, bits, dtype, n=D)
                assert d.dtype == dtype and torch.equal(
                    d, ref.uaq_dequantize_ref(*q, bits, dtype, n=D)), \
                    f"uaq_dequantize differs at {where} {bits}b"
            sep, best, sims = S_.semantic_probe(x, c)
            wsep, wbest, wsims = ref.semantic_probe_ref(x, c)
            near("sep", "semantic_probe", sep, wsep, where)
            near("sims", "semantic_probe", sims, wsims, where)
            check_best(torch, best, wbest, wsims, "semantic_probe")
        log(f"  ok {(B, S, D, L)} in {', '.join(DTYPES)}")
    for (M, N) in RAGGED_M:
        x32 = torch.randn((M, N), generator=gen, device="cuda")
        for dt in DTYPES:
            dtype = getattr(torch, dt)
            x2 = x32.to(dtype)
            for bits in (4, 8):
                q = U.uaq_quantize(x2, bits)
                for g, w in zip(q, ref.uaq_quantize_ref(x2, bits)):
                    assert torch.equal(g, w), \
                        f"uaq_quantize differs at {(M, N)} {dt}"
                assert torch.equal(
                    U.uaq_dequantize(*q, bits, dtype, n=N),
                    ref.uaq_dequantize_ref(*q, bits, dtype, n=N)), \
                    f"uaq_dequantize differs at {(M, N)} {dt}"
        log(f"  ok ragged M {(M, N)} in {', '.join(DTYPES)}")
    check_signed_zero_and_nan(torch, K)
    check_nan_probe(torch, K)
    for shape in (SERVE_SHAPE, LARGE_SHAPE):
        for name in ("fused_boundary", "uaq_quantize", "semantic_probe"):
            check_repeatable(torch, K, shape, name)
    torch.cuda.synchronize()
    return errs


def signed_zero_and_nan_rows(torch, gen, M, N):
    """(M, N) rows whose min or max is -0.0 or +0.0 (both signs in one
    row, and either alone) and rows holding a NaN (rows 3 and 5), beside
    plain rows; with fewer than 6 rows, one NaN in row 0."""
    x = torch.rand((M, N), generator=gen, device="cuda") * 3.0
    if M < 6:
        x[0, 0] = float("nan")
        return x
    x[0, :: 7] = 0.0
    x[0, 3:: 11] = -0.0
    x[1, :] = x[1].abs()
    x[1, N // 2] = -0.0
    x[2, :] = -x[2].abs()
    x[2, N - 1] = 0.0
    x[3, N // 3] = float("nan")
    x[4, :] = -0.0
    x[5, 0] = float("nan")
    x[5, 1] = 0.0
    return x


def same_with_nan(torch, g, w, exact=True):
    """NaN at the same places, and the rest bit-equal (values for zp:
    -0.0 == +0.0) or, with ``exact=False``, within TOL."""
    if g.dtype != w.dtype or g.shape != w.shape or \
            not torch.equal(torch.isnan(g), torch.isnan(w)):
        return False
    g, w = torch.nan_to_num(g), torch.nan_to_num(w)
    return torch.equal(g, w) if exact else close(g, w, **TOL)


def check_signed_zero_and_nan(torch, K):
    """The quantize (K3) and the fused boundary (K1) on rows whose min or
    max is -0.0 or +0.0 (both signs in one row, and either alone), and on
    rows holding a NaN, against the plain version in every activation
    dtype at both bit widths: codes and scale bit-equal, zp equal as
    values (-0.0 == +0.0: the kernels' min orders -0.0 first, torch's may
    return either), NaN where the plain version has NaN; K1's probe
    fields NaN where the plain version's are (a batch row holding a NaN)
    and within TOL elsewhere, ``best`` equal.  K3 at rows of several
    warps (8 rows), of one warp (2048 rows) and of the scalar path (an
    odd width); K1 at (1, 1, 16), serve's shape and an odd width."""
    ref, U, B_ = K["ref"], K["uaq"], K["boundary"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    for M, N in ((8, 768), (8, 2304), (2048, 2304), (7, 33)):
        x = signed_zero_and_nan_rows(torch, gen, M, N)
        for dt in DTYPES:
            xd = x.to(getattr(torch, dt))
            for bits in (4, 8):
                got = U.uaq_quantize(xd, bits)
                want = ref.uaq_quantize_ref(xd, bits)
                for name, g, w in zip(("payload", "scale", "zp"), got, want):
                    assert same_with_nan(torch, g, w), \
                        f"uaq_quantize {name} differs on rows with -0.0 / " \
                        f"NaN at {(M, N)} {dt} {bits}b"
                assert bool(torch.isnan(got[1][3]).all()), \
                    "a NaN row's scale is not NaN"
    log("  ok uaq_quantize on rows with -0.0 / +0.0 and NaN")
    for B, S, D in ((1, 1, 16), SERVE_SHAPE[:3], (1, 8, 33)):
        x = signed_zero_and_nan_rows(torch, gen, B * S, D).reshape(B, S, D)
        c = torch.randn((5, D), generator=gen, device="cuda")
        for dt in DTYPES:
            xd = x.to(getattr(torch, dt))
            for bits in (4, 8):
                got = B_.fused_boundary(xd, c, bits)
                want = ref.fused_boundary_ref(xd, c, bits)
                for i, name in enumerate(("payload", "scale", "zp", "feat",
                                          "sep", "best", "sims")):
                    assert same_with_nan(torch, got[i], want[i],
                                         exact=i not in (3, 4, 6)), \
                        f"fused_boundary {name} differs on rows with -0.0 " \
                        f"/ NaN at {(B, S, D)} {dt} {bits}b"
                assert bool(torch.isnan(got[1].reshape(-1)[
                    3 if B * S >= 6 else 0])), "a NaN row's scale is not NaN"
    log("  ok fused_boundary on rows with -0.0 / +0.0 and NaN")


def check_nan_probe(torch, K):
    """K1's and K4's top-1 as torch.argmax takes it: a center holding a
    NaN (its sim is NaN and the first NaN is the max), two of them, one
    past the first 32, and a token holding a NaN (every sim of its batch
    row NaN): ``best`` equal to the plain version's, sep and sims NaN
    where the plain version's are and within TOL elsewhere."""
    ref, B_, S_ = K["ref"], K["boundary"], K["semantic_cache"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    for B, S, D, L in (SERVE_SHAPE, (3, 8, 2304, 40), (3, 8, 33, 37)):
        x = torch.randn((B, S, D), generator=gen, device="cuda")
        c = torch.randn((L, D), generator=gen, device="cuda")
        cases = []
        for rows in ((2,), (4, 1), (L - 1,)):
            cc = c.clone()
            for r in rows:
                cc[r, r % D] = float("nan")
            cases.append((x, cc))
        xx = x.clone()
        xx[B - 1, S // 2, D // 2] = float("nan")
        cases.append((xx, c))
        for xi, ci in cases:
            for name, got, want in (
                    ("fused_boundary", B_.fused_boundary(xi, ci, 8)[4:],
                     ref.fused_boundary_ref(xi, ci, 8)[4:]),
                    ("semantic_probe", S_.semantic_probe(xi, ci),
                     ref.semantic_probe_ref(xi, ci))):
                assert torch.equal(got[1], want[1]), \
                    f"{name} best {got[1].tolist()} != {want[1].tolist()} " \
                    f"with a NaN at {(B, S, D, L)}"
                for i in (0, 2):
                    assert same_with_nan(torch, got[i], want[i], False), \
                        f"{name} output {i} with a NaN at {(B, S, D, L)}"
        assert bool(torch.isnan(want[0][B - 1])), "a NaN token's sep"
    log("  ok fused_boundary and semantic_probe on NaN centers and features")


def check_repeatable(torch, K, shape, name):
    """Two calls of a kernel give bit-equal outputs, and so do 50 replays
    of a captured call, which would go wrong if the fused boundary
    kernel's arrival counters did not go back to 0.  A second graph,
    captured right after the first on the same stream, is replayed before
    it and then at the same time on another stream, which would go wrong
    if the two shared state.  Every replayed output also matches the
    plain version: wire fields bit for bit, probe fields within TOL."""
    B, S, D, L = shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    xs = [torch.randn((B, S, D), generator=gen, device="cuda")
          for _ in range(2)]
    c = torch.randn((L, D), generator=gen, device="cuda")
    ref = K["ref"]
    # the call, its plain version, which outputs are probe fields, and
    # where best and sims are
    fb, plain, near, best_sims = {
        "fused_boundary": (lambda x: K["boundary"].fused_boundary(x, c, 8),
                           lambda x: ref.fused_boundary_ref(x, c, 8),
                           (3, 4, 6), (5, 6)),
        "uaq_quantize": (lambda x: K["uaq"].uaq_quantize(
            x.reshape(B * S, D), 8), lambda x: ref.uaq_quantize_ref(
                x.reshape(B * S, D), 8), (), (None, None)),
        "semantic_probe": (lambda x: K["semantic_cache"].semantic_probe(
            x, c), lambda x: ref.semantic_probe_ref(x, c), (0, 2), (1, 2)),
    }[name]
    first, second = fb(xs[0]), fb(xs[0])
    for g, w in zip(first, second):
        assert torch.equal(g, w), f"{name} not repeatable at {shape}"
    eager = [first, fb(xs[1])]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fb(xs[0])
    torch.cuda.current_stream().wait_stream(side)
    graphs, captured = [], []
    for x in xs:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            captured.append(fb(x))
    torch.cuda.synchronize()
    graphs[1].replay()
    for _ in range(50):
        graphs[0].replay()
    torch.cuda.synchronize()
    other = torch.cuda.Stream()
    for _ in range(10):
        other.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(other):
            graphs[1].replay()
        graphs[0].replay()
        torch.cuda.current_stream().wait_stream(other)
    torch.cuda.synchronize()
    for x, got, ref_out in zip(xs, captured, eager):
        for g, w in zip(got, ref_out):
            assert torch.equal(g, w), \
                f"{name} differs after graph replays at {shape}"
        want = plain(x)
        for i, (g, w) in enumerate(zip(got, want)):
            if i in near:
                assert close(g, w, **TOL), f"{name} output {i} at {shape}"
            elif i == best_sims[0]:
                check_best(torch, g, w, want[best_sims[1]], name)
            else:
                assert torch.equal(g, w), f"{name} output {i} at {shape}"
    log(f"  ok {shape}: {name} bit-equal across 2 calls, 50 graph "
        f"replays, and two graphs replayed out of order and at once")
    del graphs


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


def graph_node_types(torch, fn):
    """The types of the nodes of a CUDA graph captured from one call of
    ``fn`` (CUgraphNodeType: 0 a kernel, 1 a copy, 2 a memset), read from
    the driver: a count of launches that does not rest on the profiler's
    activity records, which have once come one short or over in 50
    calls."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        types.append(kind.value)
    del graph
    return types


def profile_requests(torch, request, n):
    """Device busy time per request and the top kernels by device time.
    Returns (busy ms per request, idle share, kernel launches per
    request), or Nones when the profiler saw no device time."""
    rows, wall = device_profile(torch, request, n)
    busy = sum(r[2] for r in rows)
    if busy <= 0:
        log("profile: no device time recorded (not measured)")
        return None, None, None
    launches = sum(r[1] for r in rows)
    log(f"profile ({n} requests, profiler on): device busy {busy:.3f} "
        f"ms/request of {wall:.3f} ms wall (idle share "
        f"{1 - busy / wall:.3f}); {launches:.0f} kernel "
        f"launches/request")
    for name, count, ms in rows[:8]:
        log(f"  {ms:8.3f} ms/request  x{count:6.1f}  {name[:90]}")
    return round(busy, 4), round(1 - busy / wall, 4), round(launches, 1)


def profile_drift(torch, request, n):
    """Two profiles of ``n`` calls of the same steady ``request``: the
    kernel names whose launch counts differ between them, as {name:
    [count in the first, count in the second]} (empty when the two
    histograms agree), and the two totals."""
    hists = []
    for _ in range(2):
        rows, _ = device_profile(torch, request, n)
        hists.append({name: round(count * n) for name, count, _ in rows})
    diff = {name: [hists[0].get(name, 0), hists[1].get(name, 0)]
            for name in set(hists[0]) | set(hists[1])
            if hists[0].get(name, 0) != hists[1].get(name, 0)}
    totals = [sum(h.values()) for h in hists]
    log(f"  profiler drift over two profiles of {n} requests: records "
        f"{totals[0]} and {totals[1]}; names that come and go: "
        + (", ".join(f"{k[:80]} {v[0]} -> {v[1]}" for k, v in
                     sorted(diff.items())) or "none"))
    return {"records": totals, "differs": diff}


def rel_err(torch, a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def init_params(torch, M, cfg, dtype=None):
    """Random weights (fp32 unless ``dtype``) from seed 0 on the card."""
    t0 = time.time()
    params = M.init_params(cfg, seed=0, device="cuda",
                           dtype=dtype or torch.float32)
    torch.cuda.synchronize()
    log(f"params: {M.param_count(params) / 1e9:.3f} B in "
        f"{time.time() - t0:.1f}s")
    return params


def serve_check(torch, arch, params, requests=24):
    """``serve`` on ``params`` (at their depth) with the launch counts set
    to 0 just before and read just after; requires the fused boundary and
    dequantize kernels to have launched.  Returns (launches, wall s)."""
    from repro_torch.kernels import _build as KB
    from repro_torch.launch.serve import serve
    KB.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    stats = serve(arch, smoke=False, requests=requests, device="cuda",
                  params=params)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(KB.LAUNCHES)
    log(f"serve wall {wall:.3f}s incl. planner and 300-task calibration "
        f"({wall / requests * 1e3:.1f} ms/request upper bound); "
        f"launches {launches}")
    for name in ("fused_boundary", "uaq_dequantize"):
        assert launches.get(name, 0) > 0, f"serve never launched {name}"
    assert 0.0 <= stats.exit_ratio <= 1.0 and stats.mean_bits > 0, stats
    pr = stats.pipeline
    assert math.isfinite(pr.mean_latency) and pr.throughput > 0
    return launches, wall


def runtime_check(torch, cfg, params, bounds):
    """On a runtime at the planner's cut: the unfused hop (quantize +
    dequantize kernels) and the standalone probe (semantic-probe kernel)
    with the launch counts set to 0 just before and read just after;
    split against monolithic logits at 4 and 8 bits within ``bounds``;
    the hop's packet and dequantized values against the plain versions on
    the same boundary activation; one steady request (fused end step +
    cloud step) timed and profiled, and profiled twice more to diff the
    kernel-name histograms.  Returns (launches, request ms, device busy ms
    or None, the profiler drift)."""
    from repro_torch.core.collab import CollabRuntime
    from repro_torch.core.costs import (A6000_SERVER, JETSON_NX, WIFI_5GHZ,
                                        transformer_graph)
    from repro_torch.core.partitioner import coach_offline
    from repro_torch.kernels import _build as KB
    from repro_torch.kernels import ref
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
        launches = dict(KB.LAUNCHES)
        psep, pbest, psims = ref.semantic_probe_ref(h, centers)
    log(f"launches {launches}")
    for name in ("uaq_quantize", "uaq_dequantize", "semantic_probe"):
        assert launches.get(name, 0) > 0, \
            f"the unfused hop and probe never launched {name}"
    assert logits4.shape == (1, cfg.vocab_size), logits4.shape
    for lg in (mono, logits4, logits8):
        assert bool(torch.isfinite(lg).all()), "non-finite logits"
    r4, r8 = rel_err(torch, logits4, mono), rel_err(torch, logits8, mono)
    log(f"cut_group={cut_group} split vs monolithic rel err: "
        f"4b {r4:.4g} (< {bounds[4]:.4g}), 8b {r8:.4g} (< {bounds[8]:.4g}); "
        f"wire bytes {pkts[0].wire_bytes} vs fp32 {8 * cfg.d_model * 4}")
    assert r8 < bounds[8] and r4 < bounds[4], (r4, r8)
    assert close(sims, psims, **TOL) and close(sep, psep, **TOL)
    check_best(torch, best, pbest, psims, "probe")
    check_hop(torch, rt, toks, mono)

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
    busy = profile_requests(torch, request, 3)[0]
    return launches, req_ms, busy, profile_drift(torch, request, 3)


def boundary_activation(rt, toks, hop):
    """The activation ``rt`` sends over ``hop``, with every hop before it
    lossless."""
    h = rt._seg_fns[0](rt.p_segments[0], toks)
    for k in range(1, hop + 1):
        h = rt._seg_fns[k](rt.p_segments[k], h)
    return h


def continue_from(rt, hop, h):
    """The logits of ``rt``'s segments after ``hop`` on the activation
    ``h``, with no quantization on the way."""
    for k in range(hop + 1, rt.n_segments):
        h = rt._seg_fns[k](rt.p_segments[k], h)
    return h


def check_hop(torch, rt, toks, mono, hop=0):
    """The packet of ``hop`` and its dequantized values bit-equal to the
    plain versions on the same boundary activation (so the kernels add
    nothing to the split's error), every dequantized value within half a
    quantum of the activation, and the logits' response to Gaussian noise
    of the same per-token norm at the boundary, for comparison with the
    split's error (the other hops lossless)."""
    from repro_torch.kernels import ref
    D = rt.cfg.d_model
    with torch.no_grad():
        h = boundary_activation(rt, toks, hop)
        for bits in (4, 8):
            pkt = rt._quantize(h, hop, bits)
            deq = pkt.dequantize()
            want = ref.uaq_quantize_ref(h.reshape(-1, D), bits)
            for g, w in zip((pkt.payload, pkt.scale, pkt.zp), want):
                assert torch.equal(g.reshape(w.shape), w), \
                    f"hop {hop} {bits}b differs from the plain quantize"
            assert torch.equal(deq, ref.uaq_dequantize_ref(
                *want, bits, n=D).reshape(h.shape)), \
                f"hop {hop} {bits}b differs from the plain dequantize"
            err = deq - h
            half = pkt.scale * (0.5 + 1e-5) + 1e-6
            assert bool((err.abs() <= half).all()), \
                f"hop {hop} {bits}b: a dequantized value is off by over " \
                f"half a quantum"
            q = rel_err(torch, deq, h)
            gen = torch.Generator(device=h.device).manual_seed(bits)
            noisy = []
            for _ in range(3):
                n = torch.randn(h.shape, generator=gen, device=h.device)
                n = n * err.norm(dim=-1, keepdim=True) \
                    / n.norm(dim=-1, keepdim=True)
                noisy.append(rel_err(torch, continue_from(rt, hop, h + n),
                                     mono))
            split = rel_err(torch, continue_from(rt, hop, deq), mono)
            log(f"  hop {hop} {bits}b == plain versions; boundary rel err "
                f"{q:.4g} (each value within half a quantum); logits rel "
                f"err: split {split:.4g} (gain {split / q:.3g}), equal-norm "
                f"Gaussian noise {', '.join(f'{x:.4g}' for x in noisy)}")


def decode_weight_bytes(cfg, params, M) -> int:
    """Bytes of weights one decode step must read: every parameter, less
    the experts a token is not routed to (E - k of E in each MoE layer)
    and, when the head is not tied, all but one row of the embedding."""
    nbytes = params["final_norm"]["scale"].element_size()
    total = M.param_count(params)
    if cfg.num_experts:
        n_moe = sum(s.moe for s in cfg.pattern) * cfg.num_groups
        total -= (3 * cfg.d_model * cfg.d_ff * n_moe
                  * (cfg.num_experts - cfg.experts_per_token))
    if "lm_head" in params and "embed" in params:
        total -= (cfg.vocab_size - 1) * cfg.d_model
    return total * nbytes


def generation_check(torch, cfg, params, prompt_len=64, new=32):
    """``generate`` greedy from a seeded prompt; every new token is the
    argmax of the forward on the generated sequence (the forward is
    causal, so its logits at position i are those of the prefix up to i),
    or a near-tie: the forward's top-2 logits within GEN_TIE_RTOL of the
    row's largest |logit|.  Then the decode steps alone, timed one by one,
    and their logits against the forward on their own sequence.  Returns
    (decode ms/token median, bound ms, all-weights bound ms)."""
    from repro_torch.models import model as M
    from repro_torch.serving import generate
    gen = torch.Generator(device="cuda").manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen,
                           device="cuda", dtype=torch.int32)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(params, cfg, prompt, new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        assert out.shape == (1, prompt_len + new), out.shape
        assert torch.equal(out[:, :prompt_len], prompt)
        h, _, _ = M.forward(params, cfg, out)
        logits = M._lm_head(params, cfg, h[0, prompt_len - 1:-1])
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        got, want = out[0, prompt_len:], torch.argmax(logits, dim=-1)
        top2 = torch.topk(logits, 2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) \
            <= GEN_TIE_RTOL * logits.abs().amax(dim=-1)
        flips = got != want.to(got.dtype)
        assert not bool((flips & ~tie).any()), \
            f"generate: tokens {torch.nonzero(flips & ~tie).flatten()} " \
            f"differ from the forward's argmax away from a near-tie"

        lg, cache = M.prefill(params, cfg, prompt, prompt_len + new)
        seq, step_logits, per = [prompt], [], []
        for t in range(new - 1):
            nxt = torch.argmax(lg, dim=-1)[:, None].to(prompt.dtype)
            seq.append(nxt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = M.decode_step(params, cfg, cache, nxt,
                                      prompt_len + t)
            torch.cuda.synchronize()
            per.append(time.perf_counter() - t0)
            step_logits.append(lg)
        seq = torch.cat(seq, dim=1)
        h, _, _ = M.forward(params, cfg, seq)
        want = M._lm_head(params, cfg, h[0, prompt_len:])
        rel = rel_err(torch, torch.cat(step_logits), want)
    assert rel < 1e-3, f"decode logits vs forward rel err {rel}"
    ms = statistics.median(per) * 1e3
    bound = decode_weight_bytes(cfg, params, M) / HBM_BYTES_PER_S * 1e3
    every = M.param_count(params) * 4 / HBM_BYTES_PER_S * 1e3
    log(f"generate {new} tokens after {prompt_len}: {gen_s:.3f}s; "
        f"{int(flips.sum())} near-tie flips; decode {ms:.3f} ms/token "
        f"(median of {new - 1}) vs weight-bytes bound {bound:.3f} ms "
        f"(all weights {every:.3f} ms); decode vs forward logits rel err "
        f"{rel:.3g} (< 1e-3)")
    return ms, bound, every


# ------------------------------------------------------------ phase 9
def three_tier_runs(torch, cfg, params, device="cuda", executor=True):
    """The three-tier main path of ``examples/edge_tier.py`` on ``params``,
    24 requests a run, with the deployment planned by the port (Jetson NX
    end, AGX Orin edge and A6000 cloud over 50 Mbps WiFi and the LAN
    backhaul): (a) the sync and async engines, each with ``classify`` through
    ``rt.run`` (the quantize kernel at both senders, the dequantize kernel
    at both receivers); with ``executor``, (b) ``AsyncHopPipeline`` running
    the runtime's fused segment handles (the fused boundary kernel at both
    intermediate segments, probes delivered through ``on_probe``) and (c)
    two tenants under wdrr, then each alone.  The launch counts are set to
    0 just before and read just after these runs; every check that
    launches kernels comes after.  Returns a dict of the runs' results."""
    import numpy as np
    from repro_torch.core.collab import CollabRuntime
    from repro_torch.core.costs import (A6000_SERVER, EDGE_AGX_ORIN, ETH_LAN,
                                        JETSON_NX, WIFI_5GHZ,
                                        transformer_graph)
    from repro_torch.core.partitioner import coach_offline_multihop
    from repro_torch.core.pipeline import TaskPlan
    from repro_torch.data.pipeline import (CorrelatedTaskStream,
                                           make_hop_calibration_sets)
    from repro_torch.kernels import _build as KB
    from repro_torch.serving import (AsyncCoachEngine, AsyncHopPipeline,
                                     CoachEngine, MultiTenantCoachEngine,
                                     TenantSpec, VirtualClock)
    devices = (JETSON_NX, EDGE_AGX_ORIN, A6000_SERVER)
    links = (WIFI_5GHZ(50.0), ETH_LAN())
    off = coach_offline_multihop(transformer_graph(cfg, batch=1, seq=128),
                                 devices, links)
    cuts = group_cuts_from_frontiers(off.decision, cfg)
    hop_bits = [int(np.mean(list(b.values()))) if b else 8
                for b in off.decision.all_hop_bits]
    log(f"plan: cuts {cuts} of {cfg.num_groups} groups, hop bits {hop_bits}, "
        f"max stage {off.times.max_stage * 1e3:.3f} ms (planner's profiles)")
    rt = CollabRuntime(cfg, params, cuts, default_bits=hop_bits)
    stream = CorrelatedTaskStream(n_labels=16, dim=cfg.d_model,
                                  correlation="medium", seed=0,
                                  n_probe_depths=2, depth_decay=0.9)
    calib = make_hop_calibration_sets(stream, n=300)
    tasks = stream.tasks(24)
    period = off.times.max_stage
    eng_kw = dict(n_labels=16, calib_feats=calib[0][0],
                  calib_labels=calib[0][1], boundary_elems=128 * cfg.d_model,
                  links=list(links), hop_bits_offline=hop_bits,
                  hop_calib=calib[1:2])

    def tokens(task):
        toks = (np.abs((task.features[:8] * 1000).astype(np.int64))
                % cfg.vocab_size).astype(np.int32)
        return torch.as_tensor(toks, device=device)[None]

    def classify(task):
        logits, _ = rt.run(tokens(task))
        pred = int(torch.argmax(logits[0]).item()) % stream.n_labels
        return task.hop_features, pred

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    out = {"rt": rt, "cuts": cuts, "hop_bits": hop_bits, "tasks": tasks,
           "tokens": tokens, "walls": {}}
    with torch.no_grad():
        KB.LAUNCHES.clear()
        for name, cls in (("sync", CoachEngine), ("async", AsyncCoachEngine)):
            eng = cls(rt, off.times, devices[0], links[0], devices[-1],
                      **eng_kw)
            out[name], out["walls"][name] = timed(lambda: eng.run_stream(
                list(tasks), arrival_period=period, classify=classify))
        if executor:
            gen = torch.Generator(device=device).manual_seed(9)
            centers = [torch.randn((16, cfg.d_model), generator=gen,
                                   device=device) for _ in range(rt.n_hops)]
            probes, cur = {}, [None]
            handles = [rt.segment_handle(
                k, probe_centers=lambda k=k: centers[k],
                on_probe=lambda k, pr: probes.__setitem__((cur[0], k), pr))
                for k in range(rt.n_segments)]

            def segment_fn(k, idx, payload):
                cur[0] = idx
                return handles[k](payload)

            plans = [TaskPlan.multihop(off.times.compute, off.times.link)
                     for _ in tasks]
            pipe = AsyncHopPipeline(rt.n_hops, links=list(links),
                                    clock=VirtualClock(),
                                    segment_fn=segment_fn)
            res, out["walls"]["executor"] = timed(lambda: pipe.run(
                lambda i, _a: plans[i].as_sim_plan(rt.n_hops), len(tasks),
                [i * period for i in range(len(tasks))],
                payloads=[tokens(t) for t in tasks]))
            out.update(executor=res, outputs=pipe.outputs, probes=probes,
                       centers=centers)

            half = len(tasks) // 2
            specs = [TenantSpec("a", half, arrival_period=period, weight=2.0),
                     TenantSpec("b", len(tasks) - half,
                                arrival_period=1.5 * period, weight=1.0)]
            split = [list(tasks[:half]), list(tasks[half:])]

            def tenants(which):
                eng = MultiTenantCoachEngine(
                    rt, off.times, devices[0], links[0], devices[-1],
                    tenants=[specs[t] for t in which], policy="wdrr",
                    **eng_kw)
                return eng.run_streams([split[t] for t in which], classify)

            out["tenants"], out["walls"]["tenants"] = timed(
                lambda: tenants((0, 1)))
            out["solo"] = [tenants((t,)) for t in (0, 1)]
        sync()
        out["launches"] = dict(KB.LAUNCHES)
    return out


def decisions(stats):
    return {"exit_ratio": stats.exit_ratio, "exit_hops": stats.exit_hops,
            "mean_bits": stats.mean_bits, "accuracy": stats.accuracy}


def three_tier_check(torch, cfg, params, device="cuda", executor=True):
    """Phase 9 on one model: the runs of ``three_tier_runs``, then their
    checks: sync and async decisions equal; each executor output equal to
    ``rt.run``'s logits within 1e-5 and each probe delivery within TOL of
    ``CollabRuntime.probe`` on the same activation; each tenant's
    decisions equal to its solo run's; every hop bit-equal to the plain
    versions and within half a quantum; the (8, 8)-bit split within
    ``THREE_TIER_BOUND`` of the monolithic forward.  Returns (launches,
    numbers for the phase's JSON)."""
    r = three_tier_runs(torch, cfg, params, device, executor)
    rt, walls = r["rt"], r["walls"]
    s, a = decisions(r["sync"]), decisions(r["async"])
    log(f"sync  {s}\nasync {a}")
    assert s == a, "the async engine decided differently from the sync one"
    result = {"cuts": list(r["cuts"]), "hop_bits": r["hop_bits"],
              "decisions": {k: (dict(v) if isinstance(v, dict) else v)
                            for k, v in s.items()},
              "wall_s": walls}
    with torch.no_grad():
        if executor:
            assert s["exit_hops"].get(1, 0) > 0, \
                f"no task exited at the edge tier: {s['exit_hops']}"
            assert not any(r["executor"].early_exit)
            worst = 0.0
            for i, task in enumerate(r["tasks"]):
                toks = r["tokens"](task)
                want, _ = rt.run(toks)
                got = r["outputs"][i]
                worst = max(worst, max_err(got, want))
                assert close(got, want, 1e-5, 1e-5), \
                    f"executor output {i} differs from rt.run: " \
                    f"{max_err(got, want)}"
                pkt, h = rt.segment_step(0, toks)
                for k in range(rt.n_hops):
                    if k:
                        pkt, h = rt.segment_step(k, pkt)
                    pr = r["probes"][(i, k)]
                    sep, best, sims = rt.probe(h, r["centers"][k])
                    assert close(pr.sims, sims, **TOL) and \
                        close(pr.sep, sep, **TOL) and \
                        close(pr.feat, h.mean(dim=1), **TOL), \
                        f"probe of task {i} at hop {k} differs"
                    check_best(torch, pr.best, best, sims, "on_probe")
            log(f"executor: {len(r['outputs'])} outputs == rt.run (max abs "
                f"err {worst:.3g}); {len(r['probes'])} probe deliveries == "
                f"CollabRuntime.probe within TOL")
            result["executor_max_abs_err"] = worst
            for t, solo in enumerate(r["solo"]):
                got = r["tenants"].reports[t].stats
                want = solo.reports[0].stats
                for f in ("exit_ratio", "mean_bits", "accuracy"):
                    assert getattr(got, f) == getattr(want, f), \
                        f"tenant {t} {f} differs from its solo run"
                log(f"tenant {t}: {decisions(got)} == solo")
        toks = r["tokens"](r["tasks"][0])
        mono = rt.monolithic(params, toks)
        for hop in range(rt.n_hops):
            check_hop(torch, rt, toks, mono, hop)
        ratios = {}
        for bits in (8, rt.default_bits_per_hop[0]):
            rb = type(rt)(cfg, params, r["cuts"],
                          default_bits=(bits,) * rt.n_hops)
            logits, _ = rb.run(toks)
            assert bool(torch.isfinite(logits).all()), "non-finite logits"
            ratios[bits] = float((logits - mono).abs().max()
                                 / mono.abs().max())
    log(f"split vs monolithic max|d|/max|ref|: "
        + ", ".join(f"{b}b {v:.4g}" for b, v in sorted(ratios.items()))
        + f" (8b < {THREE_TIER_BOUND})")
    assert ratios[8] < THREE_TIER_BOUND, ratios
    result["split_max_ratio"] = ratios
    return r["launches"], result, rt, toks


def time_request(torch, request):
    """Median wall ms of 10 steady calls of ``request`` (3 warm-up), then
    its device busy, idle share and launches under torch.profiler."""
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
    log(f"  {req_ms:.2f} ms median of 10")
    busy, idle, n = profile_requests(torch, request, 3)
    return {"request_ms": req_ms, "request_device_busy_ms": busy,
            "idle_share": idle, "launches_per_request": n}


# ------------------------------------------------------------ phase 10
# (n_micro, B_mb, S): the reference test's tokens, and enough rows (1024 a
# microbatch) for the two pods to have compute to overlap
PIPE_SHAPES = ((2, 4, 32), (8, 4, 256))
# each microbatch's max|d| / max|ref| against the monolithic forward, the
# reference test's bound (tests/test_collab.py:94-101)
PIPE_BOUND = 0.05


def time_steps(torch, fns, rounds=6):
    """Median wall ms (host clock to a synchronize) and ms between two
    CUDA events on the current stream (which the two-stream step joins at
    its start and end) of each of ``fns`` (name -> call), after a warm-up
    call of each: ``rounds`` rounds, the calls in turns, the order
    reversed every other round, so that a host whose speed drifts during
    the phase weighs on every call alike."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    walls = {k: [] for k in fns}
    evs = {k: [] for k in fns}
    names = list(fns)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            fns[name]()
            b.record()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            evs[name].append(a.elapsed_time(b))
    return {k: (statistics.median(walls[k]), statistics.median(evs[k]))
            for k in fns}


def pipeline_check(torch, M, cfg, params, shape):
    """The two-pod pipeline (``make_collab_pipeline_step``, 8 bits) on
    ``params`` over tokens of ``shape``: the two-stream step with the
    launch counts set to 0 just before and read just after; then its
    output against the pods serialized on one stream and against the run
    with the plain quantize and dequantize (bit-equal), each microbatch
    against the monolithic forward (PIPE_BOUND), the boundary's and the
    logits' relative L2 error for microbatch 0 (the model's
    amplification), and one step timed with the overlap and serialized,
    in turns; one serialized step profiled (kernel time and launches a
    step: the same kernels run in both modes).  Returns (launches,
    numbers)."""
    from repro_torch.core.collab import PodMesh, make_collab_pipeline_step
    from repro_torch.kernels import _build as KB
    from repro_torch.kernels import ops as KOPS
    n_micro, B, S = shape
    gen = torch.Generator(device="cuda").manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         device="cuda", dtype=torch.int32)
    steps = {name: make_collab_pipeline_step(cfg, mesh, bits=8,
                                             n_micro=n_micro, use_kernel=k)
             for name, mesh, k in (
                 ("overlap", PodMesh.on_card("cuda"), True),
                 ("serial", PodMesh.on_card("cuda", overlap=False), True),
                 ("plain", PodMesh.on_card("cuda"), False))}
    with torch.no_grad():
        KB.LAUNCHES.clear()
        torch.cuda.synchronize()
        out = steps["overlap"](params, toks)
        torch.cuda.synchronize()
        launches = dict(KB.LAUNCHES)
        assert out.shape == (n_micro, B, cfg.vocab_size), out.shape
        assert bool(torch.isfinite(out).all()), "non-finite logits"
        assert torch.equal(out, steps["serial"](params, toks)), \
            f"two streams differ from one at {shape}"
        assert torch.equal(out, steps["plain"](params, toks)), \
            f"the kernels' pipeline differs from the plain versions' at " \
            f"{shape}"
        rels = []
        for i in range(n_micro):
            h, _, _ = M.forward(params, cfg, toks[i])
            want = M._lm_head(params, cfg, h[:, -1]).float()
            rels.append(float((out[i].float() - want).abs().max()
                              / want.abs().max()))
            if i == 0:
                half = cfg.num_groups // 2
                hb = M.run_groups(M.group_slice(params["groups"],
                                                slice(0, half)),
                                  M._embed(params, cfg, toks[0]), cfg,
                                  M.positions_for(B, S, "cuda"))
                deq = KOPS.wire_dequantize(
                    *KOPS.wire_quantize(hb.reshape(-1, cfg.d_model), 8),
                    8, out_dtype=hb.dtype).reshape(hb.shape)
                bnd = rel_err(torch, deq.float(), hb.float())
                lg = rel_err(torch, out[0].float(), want)
        times = time_steps(torch, {
            name: lambda s=steps[name]: s(params, toks)
            for name in ("overlap", "serial")})
        # the same kernels run in both modes: one serialized step profiled
        log(f"  {shape} serialized, under the profiler:")
        busy, _, per_step = profile_requests(
            torch, lambda: steps["serial"](params, toks), 1)
    log(f"  {shape}: launches {launches}; two streams == one stream == "
        f"plain K3/K2; max|d|/max|ref| per microbatch "
        f"{', '.join(f'{r:.4g}' for r in rels)} (< {PIPE_BOUND}); "
        f"microbatch 0 rel L2: boundary {bnd:.4g}, logits {lg:.4g} "
        f"(amplification {lg / bnd:.3g})")
    for name, (wall, dev) in times.items():
        log(f"  {shape} {name:7s}: {wall:.2f} ms wall, {dev:.2f} ms between "
            f"device events (median of 6, in turns)")
    assert max(rels) < PIPE_BOUND, rels
    for name in ("uaq_quantize", "uaq_dequantize"):
        assert launches.get(name, 0) == n_micro, \
            f"the pipeline launched {name} {launches.get(name, 0)} times"
    return launches, {
        "max_ratio": rels, "boundary_rel_l2": bnd, "logits_rel_l2": lg,
        "overlap_ms": times["overlap"][0],
        "overlap_event_ms": times["overlap"][1],
        "serial_ms": times["serial"][0],
        "serial_event_ms": times["serial"][1],
        "kernel_ms": busy, "launches_per_step": per_step}


# ------------------------------------------------------------ phase 11
def tree_to(torch, tree, device):
    from repro_torch.training.optim import tree_map
    return tree_map(lambda t: t.to(device), tree)


def train_card_vs_cpu(torch, M, cfg):
    """One train step's loss and gradients on the card against the CPU,
    on the same CPU-drawn weights and batch (B = 2, S = 64): loss within
    1e-5 relative, every gradient leaf within 1e-3 relative L2.  Returns
    (card params, loss rel err, worst leaf rel L2)."""
    from repro_torch.launch import steps as ST
    from repro_torch.training.optim import tree_leaves
    params = M.init_params(cfg, seed=0, device="cpu")
    gparams = tree_to(torch, params, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(12))
    b = {"tokens": toks, "labels": toks}
    loss, _, grads = ST.loss_and_grads(params, cfg, b)
    gloss, _, ggrads = ST.loss_and_grads(gparams, cfg,
                                         tree_to(torch, b, "cuda"))
    lrel = abs(float(gloss) - float(loss)) / abs(float(loss))
    worst = max(float(torch.linalg.vector_norm(g.cpu() - w)
                      / torch.linalg.vector_norm(w))
                for g, w in zip(tree_leaves(ggrads), tree_leaves(grads)))
    log(f"  {cfg.name} ({cfg.num_layers} layers, "
        f"{M.param_count(params) / 1e9:.3f} B): loss {float(gloss):.6f} "
        f"card vs {float(loss):.6f} CPU (rel {lrel:.3g} < 1e-5); worst "
        f"gradient leaf rel L2 {worst:.3g} (< 1e-3)")
    assert lrel < 1e-5 and worst < 1e-3, (lrel, worst)
    return gparams, lrel, worst


def checkpoint_round_trip(torch, cfg, params):
    """A donated train step on the card, then its params and AdamW state
    saved (``repro_torch.checkpoint``, the JAX package's format) and
    loaded back onto the card: every leaf bit-equal.  Returns (GB
    written, save s, load s)."""
    import tempfile
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.launch import steps as ST
    from repro_torch.training.optim import (AdamWConfig, adamw_init,
                                            tree_leaves, tree_map)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                         device="cuda")
    p2, o2, _, _ = ST.make_train_step(cfg, opt_cfg, donate=True)(
        params, adamw_init(params, opt_cfg),
        {"tokens": toks, "labels": toks})
    tree = {"params": p2, "opt": o2}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        path = save_checkpoint(d, 1, tree)
        t_save = time.time() - t0
        gb = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path)) / 1e9
        t0 = time.time()
        back = load_checkpoint(d, 1, tree_map(torch.empty_like, tree))
        torch.cuda.synchronize()
        t_load = time.time() - t0
    for a, w in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.device == w.device and a.dtype == w.dtype and \
            torch.equal(a, w), "a checkpoint leaf differs after the round trip"
    log(f"  checkpoint of {cfg.name} params + AdamW state: {gb:.2f} GB, "
        f"saved in {t_save:.1f}s, loaded in {t_load:.1f}s, bit-equal")
    return gb, t_save, t_load


def train_full_width(torch, M):
    """``train("gemma2-2b", smoke=False, steps=5, batch=8, seq=256)`` on
    the card: fp32 params and AdamW state, remat.  Every loss finite;
    ms per step (median of steps 2-5), tokens per second, peak memory,
    and the fp32 bound: 8 N flops a token (forward, its recompute, and a
    backward of twice the forward) at the card's fp32 peak."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    batch, seq = 8, 256
    torch.cuda.reset_peak_memory_stats()
    secs = []
    params, losses = train("gemma2-2b", smoke=False, steps=5, batch=batch,
                           seq=seq, device="cuda", log_every=1,
                           step_seconds=secs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = M.param_count(params)
    assert len(losses) == 5 and all(math.isfinite(x) for x in losses), \
        losses
    ms = statistics.median(secs[1:]) * 1e3
    bound = 8 * n * batch * seq / FP32_OPS_PER_S * 1e3
    log(f"  gemma2-2b full width ({get_config('gemma2-2b').num_layers} "
        f"layers, {n / 1e9:.3f} B, fp32): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; step ms "
        f"{', '.join(f'{x * 1e3:.1f}' for x in secs)} (median of 2-5: "
        f"{ms:.1f}); {batch * seq / ms * 1e3:.0f} tokens/s; peak "
        f"{peak:.2f} GB; fp32 bound {bound:.1f} ms ({100 * bound / ms:.1f}%)")
    return {"losses": losses, "step_s": secs, "ms_per_step": ms,
            "tokens_per_s": batch * seq / ms * 1e3, "peak_gb": peak,
            "fp32_bound_ms": bound, "params": n}


# ------------------------------------------------------------ phase 12
# the dry-run pairs of phase 12 (b), on the 16x16 mesh of a fake group
DRYRUN_PAIRS = [["gemma2-2b", "train_4k"], ["mixtral-8x7b", "decode_32k"]]
_DRYRUN = r"""
import json, sys
from repro_torch.launch import dryrun as D
D.init_fake_group(256)
out = {}
for arch, shape in json.loads(sys.argv[1]):
    _, rep = D.lower_pair(arch, shape, False)
    out[f"{arch} {shape}"] = rep
print(json.dumps(out))
"""


def full(t):
    """A DTensor's global value (here one device holds all of it)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def dtensor_serve_check(torch, M, mesh):
    """Full-width gemma2-2b, a prefill of (2, 64) tokens and 8 decode
    steps through ``make_prefill_step`` / ``make_serve_step``: the params
    as DTensors in the serving layout on the 1x1 card mesh with the hooks
    live, against the same steps on plain tensors (the same inputs): every
    logit bit-equal.  Returns (max |d| over the steps, decode ms plain,
    decode ms DTensor)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.launch.sharding import (NamedSharding, activation_specs,
                                             batch_spec, distribute,
                                             shard_params)
    from repro_torch.models.shardctx import activation_sharding
    cfg = get_config("gemma2-2b")
    params = init_params(torch, M, cfg)
    B, S, steps = 2, 64, 8
    gen = torch.Generator(device="cuda").manual_seed(20)
    toks = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                         device="cuda", dtype=torch.int32)
    prefill = ST.make_prefill_step(cfg, max_seq=S + steps)
    serve = ST.make_serve_step(cfg)

    def run(p, wrap):
        logits, cache = prefill(p, wrap(toks[:, :S]))
        outs, ms = [full(logits)], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = serve(p, cache, wrap(toks[:, S + i:S + i + 1]),
                                  S + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(full(logits))
        return outs, statistics.median(ms)

    with torch.no_grad():
        want, ms_plain = run(params, lambda x: x)
        with activation_sharding(activation_specs(cfg, mesh, B)), \
                implicit_replication():
            dp = distribute(params, shard_params(params, mesh, cfg,
                                                 serving=True))
            got, ms_dt = run(dp, lambda x: distribute(x, NamedSharding(
                mesh, batch_spec(mesh, B, 1))))
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    log(f"  gemma2-2b full width, serving layout on the 1x1 mesh: prefill "
        f"+ {steps} decode steps, logits bit-equal to plain tensors: "
        f"{equal} (max |d| {worst:.3g}); decode step {ms_plain:.2f} ms "
        f"plain, {ms_dt:.2f} ms DTensor (+{ms_dt - ms_plain:.2f} ms of "
        f"DTensor dispatch on the host)")
    assert equal, f"DTensor logits differ from plain ones by {worst}"
    return worst, ms_plain, ms_dt


def dtensor_train_check(torch, M, mesh):
    """One train step's loss and gradients of full-width gemma2-2b cut
    to 4 layers (phase 11's step, B = 2, S = 64) in the FSDP layout on the
    1x1 card mesh against plain tensors: loss bit-equal, every gradient
    leaf within 1e-6 relative L2.  Returns (loss rel, worst leaf)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.launch.sharding import (NamedSharding, activation_specs,
                                             batch_spec, distribute,
                                             shard_params)
    from repro_torch.models.shardctx import activation_sharding
    from repro_torch.training.optim import tree_leaves
    cfg = dataclasses.replace(get_config("gemma2-2b"), num_layers=4)
    params = M.init_params(cfg, seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(12)
                         ).to("cuda")
    b = {"tokens": toks, "labels": toks}
    loss, _, grads = ST.loss_and_grads(params, cfg, b)
    with activation_sharding(activation_specs(cfg, mesh, 2)), \
            implicit_replication():
        dp = distribute(params, shard_params(params, mesh, cfg))
        db = distribute(b, {k: NamedSharding(mesh, batch_spec(mesh, 2, 1))
                            for k in b})
        dloss, _, dgrads = ST.loss_and_grads(dp, cfg, db)
    dloss = full(dloss)
    lrel = abs(float(dloss) - float(loss)) / abs(float(loss))
    worst = max(float(torch.linalg.vector_norm(full(g) - w)
                      / torch.linalg.vector_norm(w))
                for g, w in zip(tree_leaves(dgrads), tree_leaves(grads)))
    log(f"  gemma2-2b 4 layers, FSDP layout on the 1x1 mesh: loss "
        f"{float(dloss):.7f} DTensor vs {float(loss):.7f} plain (bit-equal: "
        f"{bool(torch.equal(dloss, loss))}); worst gradient leaf rel L2 "
        f"{worst:.3g} (< 1e-6)")
    assert torch.equal(dloss, loss) and worst < 1e-6, (lrel, worst)
    return lrel, worst


def dryrun_check():
    """``launch.dryrun`` of DRYRUN_PAIRS on the 16x16 mesh of a fake
    256-rank group, in a subprocess of its own: per device the flops, HBM
    bytes, collective bytes by kind, the roofline terms and the trace
    seconds."""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _DRYRUN,
                        json.dumps(DRYRUN_PAIRS)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"the dry-run failed: {r.stderr[-3000:]}"
    reps = json.loads(r.stdout.strip().splitlines()[-1])
    out = {}
    for pair, rep in reps.items():
        roof, coll = rep["roofline"], rep["collectives"]
        log(f"  {pair} on {rep['mesh']} ({rep['devices']} devices, "
            f"{'serving' if rep['serving_layout'] else 'FSDP'} layout), per "
            f"device: {roof['flops']:.4g} flops, {roof['hbm_bytes']:.4g} HBM "
            f"bytes, collectives " + ", ".join(
                f"{k} {v:.4g}" for k, v in coll.items()) +
            f" B; t_compute {roof['t_compute_s']:.4g} s, t_memory "
            f"{roof['t_memory_s']:.4g} s, t_collective "
            f"{roof['t_collective_s']:.4g} s ({roof['bottleneck']}); "
            f"memory {rep['memory']['total_nonalias_bytes'] / 1e9:.2f} GB; "
            f"traced in {rep['trace_s']} s")
        assert roof["flops"] > 0 and roof["hbm_bytes"] > 0 and all(
            math.isfinite(v) for v in coll.values()), rep
        out[pair] = {k: rep[k] for k in ("trace_s", "memory", "cost",
                                         "collectives", "roofline",
                                         "useful_flop_frac")}
    return out


# phase 12 (c): the reduced train steps on a fake 4x4 mesh
PROBE_ARCHS = ["jamba-1.5-large-398b", "llama4-scout-17b-a16e",
               "mamba2-130m", "mixtral-8x7b", "qwen3-14b"]


def probe_start():
    """``tools/dtensor_probe.py 4,4`` on PROBE_ARCHS' train steps, started
    in a subprocess of its own."""
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "dtensor_probe.py"),
         "4,4", ",".join(PROBE_ARCHS), "--jobs", "train"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def probe_check(proc):
    """Waits for ``probe_start``'s probe: every step must run.  Returns
    {arch: seconds of its step}."""
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    secs = {}
    for line in out.splitlines():
        if line.startswith(("ok ", "FAIL ", "torch ")):
            log(f"  {line[:300]}")
        if line.startswith("ok "):
            secs[line.split()[1]] = float(line.split()[-1].rstrip("s"))
    assert proc.returncode == 0 and list(secs) == PROBE_ARCHS, \
        f"the 4x4 probe failed: {out[-2000:]} {err[-2000:]}"
    return secs


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
    from repro_torch.kernels import _build as KB
    from repro_torch.kernels import boundary, ref, semantic_cache, uaq
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
    t_large4 = time_kernels(torch, K, LARGE_SHAPE, inner=3, outer=10, bits=4)
    # serve's shape at mamba2-130m's and mixtral-8x7b's widths
    t_width = {D: time_kernels(torch, K, (1, 8, D, 16), inner=200, outer=20)
               for D in (768, 4096)}
    t_width4 = {D: time_kernels(torch, K, (1, 8, D, 16), inner=200, outer=20,
                                bits=4) for D in (768, 4096)}
    # the kernels K1 / K3 / K4 launch per call at serve's shape: one each
    x = torch.randn(SERVE_SHAPE[:3], device="cuda")
    c = torch.randn((SERVE_SHAPE[3], SERVE_SHAPE[2]), device="cuda")
    for name, fn in (("fused_boundary", lambda: boundary.fused_boundary(
            x, c, 8)), ("uaq_quantize", lambda: uaq.uaq_quantize(
                x.reshape(-1, SERVE_SHAPE[2]), 8)),
            ("semantic_probe", lambda: semantic_cache.semantic_probe(x, c))):
        rows, _ = device_profile(torch, fn, 50)
        parts = [f"{KERNEL_NAME.search(n).group()} x{count:.2f} "
                 f"{ms * 1e3:.2f} us" for n, count, ms in rows]
        nodes = graph_node_types(torch, fn)
        log(f"  {name} at {SERVE_SHAPE}, per call (profiler, eager): "
            + "; ".join(parts) + f"; captured: node types {nodes}")
        # the capture's own counter buffer is filled inside it
        extra = graph_node_types(torch, lambda: KB.arrival_counters(
            x, 64)) if name == "fused_boundary" else []
        assert len(rows) == 1 and sorted(nodes) == sorted(extra + [0]), \
            f"{name} should be one kernel launch per call: {parts}, " \
            f"graph node types {nodes} (0: a kernel)"

    launches = {}  # summed over every phase's main-path run

    def add_launches(phase_launches):
        for name, n in phase_launches.items():
            launches[name] = launches.get(name, 0) + n

    results = {}
    log("== phase 4: serve 24 requests on full-width gemma2-2b")
    cfg = get_config("gemma2-2b")
    params = init_params(torch, M, cfg)
    serve_launches, wall = serve_check(torch, "gemma2-2b", params)
    add_launches(serve_launches)

    log("== phase 5: unfused hop and standalone probe on the same weights")
    second_launches, req_ms, busy_ms, drift = runtime_check(
        torch, cfg, params, SPLIT_BOUND)
    add_launches(second_launches)
    results["gemma2-2b"] = {"serve_wall_s": wall, "request_ms": req_ms,
                            "request_device_busy_ms": busy_ms,
                            "profiler_drift": drift}

    for phase, name, cfg in (
            (6, "mamba2-130m", get_config("mamba2-130m")),
            (7, "mixtral-8x7b", dataclasses.replace(
                get_config("mixtral-8x7b"), num_layers=4))):
        log(f"== phase {phase}: serve 24 requests, the unfused hop and the "
            f"probe on full-width {name} ({cfg.num_layers} layers)")
        params = None  # the previous phase's weights go first
        torch.cuda.empty_cache()
        params = init_params(torch, M, cfg)
        lw, wall = serve_check(torch, name, params)
        add_launches(lw)
        lr, req_ms, busy_ms, drift = runtime_check(torch, cfg, params,
                                                   SPLIT_BOUND_SCALED)
        add_launches(lr)
        results[name] = {"layers": cfg.num_layers, "serve_wall_s": wall,
                         "request_ms": req_ms,
                         "request_device_busy_ms": busy_ms,
                         "profiler_drift": drift}

    log("== phase 8: greedy generation, 32 tokens after 64")
    # phase 7's mixtral weights first (dropless, as tests/test_decode.py
    # runs MoE decode), then the other two from their phases' seed
    for name, gcfg in (
            ("mixtral-8x7b", dataclasses.replace(cfg, capacity_factor=100.0)),
            ("gemma2-2b", get_config("gemma2-2b")),
            ("mamba2-130m", get_config("mamba2-130m"))):
        log(f"  {name} ({gcfg.num_layers} layers)")
        if params is None:
            params = init_params(torch, M, gcfg)
        ms, bound, every = generation_check(torch, gcfg, params)
        results[name].update(decode_ms_per_token=ms, decode_bound_ms=bound,
                             decode_all_weights_ms=every)
        params = None
        torch.cuda.empty_cache()

    log("== phase 9: the three-tier end -> edge -> cloud path "
        "(examples/edge_tier.py) on full-width mamba2-130m, then gemma2-2b")
    t9 = time.time()
    cfg = get_config("mamba2-130m")
    params = init_params(torch, M, cfg)
    lt, res, rt, toks = three_tier_check(torch, cfg, params)
    log(f"phase 9 launches {lt}")
    for name in ("fused_boundary", "uaq_dequantize", "uaq_quantize"):
        assert lt.get(name, 0) > 0, f"phase 9 never launched {name}"
    add_launches(lt)
    log("steady three-tier request (rt.run: end segment + quantize + edge "
        "segment + dequantize/quantize + cloud segment + dequantize + head)")
    res.update(time_request(torch, lambda: rt.run(toks)))
    results["three-tier mamba2-130m"] = res
    params = rt = None
    torch.cuda.empty_cache()
    cfg = get_config("gemma2-2b")
    params = init_params(torch, M, cfg)
    lg, res, _, _ = three_tier_check(torch, cfg, params, executor=False)
    log(f"gemma2-2b three-tier at the planner's {res['hop_bits']}-bit hops: "
        f"no kernel is required there (bits outside 4/8 run the plain "
        f"versions on the card, as in the JAX package); launches {lg}")
    add_launches(lg)
    results["three-tier gemma2-2b"] = res
    params = None
    torch.cuda.empty_cache()
    log(f"phase 9 in {time.time() - t9:.1f}s")

    log("== phase 10: the two-pod pipeline on full-width qwen3-14b (bf16, "
        "8 bits): pods on two CUDA streams")
    t10 = time.time()
    cfg = get_config("qwen3-14b")
    params = init_params(torch, M, cfg, torch.bfloat16)
    results["pipeline qwen3-14b"] = {}
    for shape in PIPE_SHAPES:
        lp, res = pipeline_check(torch, M, cfg, params, shape)
        add_launches(lp)
        results["pipeline qwen3-14b"][str(shape)] = res
    params = None
    torch.cuda.empty_cache()
    log(f"phase 10 in {time.time() - t10:.1f}s (budget 120 s)")

    log("== phase 11: training on the card")
    t11 = time.time()
    log(" (a) one train step, card against CPU")
    res = {}
    for cfg in (dataclasses.replace(get_config("gemma2-2b"), num_layers=4),
                get_config("mamba2-130m")):
        gparams, lrel, worst = train_card_vs_cpu(torch, M, cfg)
        res[f"{cfg.name} {cfg.num_layers} layers"] = {
            "loss_rel": lrel, "worst_grad_rel_l2": worst}
        if cfg.name.startswith("gemma2"):
            log(" (c) checkpoint round trip on the card")
            gb, t_save, t_load = checkpoint_round_trip(torch, cfg, gparams)
            res["checkpoint"] = {"gb": gb, "save_s": t_save,
                                 "load_s": t_load}
        gparams = None
        torch.cuda.empty_cache()
    log(" (b) full-width gemma2-2b, 5 steps")
    res["full gemma2-2b"] = train_full_width(torch, M)
    results["training"] = res
    torch.cuda.empty_cache()
    log(f"phase 11 in {time.time() - t11:.1f}s (budget 180 s)")

    log("== phase 12: the launch tooling on DTensor")
    t12 = time.time()
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh("cuda")
    log(f" (a) the 1x1 card mesh: {mesh}")
    worst, ms_plain, ms_dt = dtensor_serve_check(torch, M, mesh)
    torch.cuda.empty_cache()
    lrel, gworst = dtensor_train_check(torch, M, mesh)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(" (b) the dry-run on the 16x16 mesh and (c) the reduced train "
        "steps on a fake 4x4 mesh (two subprocesses side by side)")
    probe = probe_start()
    try:
        dryrun = dryrun_check()
    except BaseException:
        probe.kill()
        probe.wait()
        raise
    probe_secs = probe_check(probe)
    results["dtensor"] = {
        "serve_max_abs_diff": worst, "decode_ms_plain": ms_plain,
        "decode_ms_dtensor": ms_dt, "train_loss_rel": lrel,
        "train_worst_grad_rel_l2": gworst, "dryrun": dryrun,
        "train_4x4_s": probe_secs}
    log(f"phase 12 in {time.time() - t12:.1f}s (budget 60 s)")

    assert "jax" not in sys.modules and "repro" not in sys.modules, \
        "the port imported JAX or the JAX package"

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels = []
    for name in REPLACES:
        s = t_serve[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": int(launches[name]),
            "max_abs_err": errs[name], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": None,
            "shape": list(SERVE_SHAPE), "bits": 8,
            "int4": {"ms": t_serve4[name]["ms"],
                     "plain_ms": t_serve4[name]["plain_ms"],
                     "bound_ms": t_serve4[name]["bound_ms"]},
            "large": dict(t_large[name], shape=list(LARGE_SHAPE), bits=8),
            "large_int4": dict(t_large4[name], shape=list(LARGE_SHAPE),
                               bits=4),
            **{f"d{D}": dict(t[name], shape=[1, 8, D, 16], bits=8)
               for D, t in t_width.items()},
            **{f"d{D}_int4": dict(t[name], shape=[1, 8, D, 16], bits=4)
               for D, t in t_width4.items()},
        })
    log(json.dumps({"phases": results}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
