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
     stream are replayed out of order and at once; the SSD mixer (K5,
     ``kernels/ssd.py``) against ``models.ssm.mixer_plain`` on the same
     inputs at mamba2-130m's widths, (1, 8) and (1, 128) tokens and two
     chunks from a given state with the final state returned; the
     projection kernels (K6, ``kernels/ssd_proj.py``) against the fp32
     products at 1, 3, 8 and 16 rows, and bit-equal at a second call;
  3. time each kernel and its plain version at 8 and 4 bits (CUDA graphs
     of back-to-back launches, CUDA events, median) beside the
     bytes/operations bound, at serve's shape on gemma2-2b, mamba2-130m
     and mixtral-8x7b widths and at a large shape, and require one kernel
     launch per call of the fused boundary, quantize and probe (one
     kernel node in a graph captured from a call, beside what the fused
     boundary's counters add there, and no other kernel under the
     profiler); the SSD mixer and its plain chain at (1, 8, 768) and
     (1, 128, 768) beside the mixer's own bytes / operations bound; the
     projection kernels at 8 rows (768 -> 3352 over five weights, 1536 ->
     768), each call on the next of 24 layers' weights (out of L2), beside
     their weight bytes' bound, the plain products and one cuBLAS product
     (``library_ms``);
  4. serve 24 requests on full-width gemma2-2b (random weights from a
     seed) through ``repro_torch.launch.serve.serve`` and require the
     fused boundary and dequantize kernels to have launched;
  5. on a runtime over the same weights, run the unfused hop (quantize +
     dequantize kernels) and the standalone probe (semantic-probe
     kernel), check the logits against the monolithic forward, time one
     steady request, whose segments are ``core.jit``'s CUDA graphs (the
     reference's ``jax.jit``): its logits against the bare segment
     functions' (bit-equal, or within JIT_RTOL), no capture over the 13
     timed and profiled requests, one graph replay a segment, host
     launches from the counters and the eager request's kernel nodes;
     profile where its device time goes, and diff the kernel-name
     histograms of two more profiles of it;
  6. phases 4 and 5 on full-width mamba2-130m (24 layers), every
     ``mamba_forward`` call of both on the fused SSD mixer
     (``models.ssm.PATHS``), and in serve as many launches of each of its
     kernels as calls, and of each projection kernel as the calls
     ``models.ssm.PROJ_PATHS`` counts "fused" (some at least);
  7. phases 4 and 5 on full-width mixtral-8x7b cut to 4 of its 32 layers
     (the 32 take ~187 GB in fp32, more than one card holds);
  8. greedy ``generate`` of 32 tokens after a 64-token prompt on that
     mixtral (dropless), full-width gemma2-2b and mamba2-130m: every token
     the forward's argmax (or a near-tie), decode ms/token through a
     jitted step (one capture for the 31 steps; its logits against the
     bare step's) and through the bare step, beside the weight-bytes
     bound;
  9. the three-tier end -> edge -> cloud path of ``examples/edge_tier.py``,
     planned and served through its twin ``examples_torch/edge_tier.py``,
     on full-width mamba2-130m (the planner's cuts 3 and 12 of 24 groups,
     4-bit hops): sync and async engines whose ``classify`` runs
     ``rt.run`` (quantize and dequantize kernels at every hop), the
     executor running the runtime's fused segment handles (fused boundary
     kernel) and two tenants under wdrr, 24 requests each, with equal
     decisions across engines and against each tenant's solo run; every
     hop bit-equal to the plain versions, the (8, 8)-bit split within
     0.05 of the monolithic forward, and one steady request measured as
     in phase 5; then the engines on full-width gemma2-2b at its 6-bit plan
     (no kernel there: 6-bit hops run the plain versions);
  10. the two-pod pipeline (``make_collab_pipeline_step``, 8 bits) on
     full-width qwen3-14b in bf16, the pods on two CUDA streams, at the
     reference test's (2, 4, 32) tokens and at (8, 4, 256): the quantize
     and dequantize kernels once a microbatch, the output bit-equal to the
     pods serialized on one stream and to the plain versions' run, each
     microbatch within 0.05 of the monolithic forward, one step timed
     with the overlap and serialized; and the two-stream step under
     ``core.jit`` (one CUDA graph holding both streams, as the reference
     test jits its step): bit-equal to the eager, serialized and plain
     steps, one capture over every timed step, one replay a step, host
     launches a step from the counters, the kernel nodes of the step
     captured whole, and its ms a step timed in turns with the eager
     ones;
  11. training: one step's loss and gradients on the card against the CPU
     (gemma2-2b at full width cut to 4 layers, full-width mamba2-130m),
     then three steps of the train step jitted with params and opt_state
     donated (``launch/train.py``'s step) against three eager donated
     steps on the same weights and batches (loss and every params, m and
     v leaf bit-equal or within JIT_RTOL, ``step == 3``, one capture,
     the donated outputs the caller's tensors) and both timed in turns;
     a checkpoint round trip of the stepped params and AdamW state on
     the card, and the jitted ``launch.train.train`` on full-width
     gemma2-2b (fp32, 5 steps of 8 x 256 tokens): ms per step, tokens per
     second, peak memory (under the card's 80 GB) and the fp32 bound;
  12. the launch tooling on DTensor: (a) on the 1x1 card mesh (a one-rank
     NCCL group), full-width gemma2-2b's prefill of (2, 64) tokens and 8
     decode steps with the parameters as DTensors in the serving layout
     and the activation constraints live, eager and under ``core.jit``
     (the counterpart of ``jax.jit`` on sharded arrays: one capture of
     the decode step for the 8 positions), bit-equal to the same steps on
     plain tensors, eager and jitted (the ms of a decode step all four
     ways, host launches a jitted DTensor step, the kernel, NCCL and copy
     nodes of the DTensor and the plain step captured whole); a train
     step of the 4-layer gemma2-2b in the FSDP layout: loss bit-equal,
     gradients within 1e-6; then three steps of it jitted with params and
     opt_state donated against three eager donated DTensor steps, as in
     phase 11 (a), and both timed in turns; (b) in a subprocess, the
     dry-run of gemma2-2b train_4k and mixtral-8x7b decode_32k on the
     16x16 mesh of a fake 256-rank group, and beside it llama4-scout
     decode_32k on the 2x16x16 mesh
     (``tools/dryrun_vs_reference.py --side port``, 512 fake ranks): per
     device flops, HBM and collective bytes, roofline terms, and the
     flops, collective bytes and memory against the reference's own
     dry-run of the same pairs (constants made where JAX is): at most
     1.3x, 2x and 2x; (c) beside (b), in a subprocess, ``tools/dtensor_probe.py``: the
     reduced train steps of jamba, llama4, mamba2, mixtral and qwen3 (B,
     S = 4, 32, two microbatches of 2 rows, which do not divide the
     4-way data axis) on meta DTensors over the 4x4 CUDA mesh of a fake
     16-rank group, hooks live: each step runs;
  13. ``examples_torch/quickstart.py`` (the twin of
     ``examples/quickstart.py``) on the card: the quantize, dequantize
     and probe kernels launched through their wrappers, the split within
     the 8-bit bound of the monolithic model;
  then print each phase's numbers, the card's name and power limit, the
  kernels' JSON line (launches summed over phases 4-7's, 9's, 10's and
  13's main-path runs), and the contract line.

Exits with code 2 and prints no result when CUDA is not available or
``src/repro_torch`` and ``examples_torch`` are not beside this script.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import itertools
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
# a jitted request's or decode step's logits against the eager
# functions' on the same inputs: bit-equal, or within this (max |d| over
# max |ref|) where a GEMM under capture picks another cuBLAS algorithm
JIT_RTOL = 1e-6
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
# K5, the mamba2 SSD mixer (kernels/ssd.py), replaces no pallas_call: the
# JAX package writes the chain in jnp (mamba_forward there) and XLA fuses it
SSD_SOURCE = f"{CSRC}/ssd_mixer.cu"
SSD_PLAIN = "src/repro/models/ssm.py:152"
SSD_KERNELS = ("ssd_prep", "ssd_chunk", "ssd_state", "gated_rmsnorm")
# (B, S, ssm_chunk, h0 given and the final state returned): serve's two
# task lengths, and two chunks of 256 (the second padded) from a state
SSD_CHECKS = [(1, 8, 256, False), (1, 128, 256, False), (1, 300, 256, True)]
# K5 against its plain chain: max |d| over the chain's max |value| (sums
# over the state and the chunk run in another order)
SSD_RTOL = 1e-4
# K6, a mamba2 block's projections at up to 16 rows (kernels/ssd_proj.py),
# replaces no pallas_call either: the JAX package leaves the dots to XLA
PROJ_SOURCE = f"{CSRC}/ssd_proj.cu"
PROJ_PLAIN = "src/repro/models/ssm.py:157,174"
PROJ_IN = ("in_z", "in_x", "in_B", "in_C", "in_dt")
PROJ_ROWS = (1, 3, 8, 16)
# K6 against the fp32 product: max |d| over the product's max |value| (the
# sums run in another order than cuBLAS's)
PROJ_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def example(name):
    """``examples_torch/<name>.py``, the twin of ``examples/<name>.py``,
    as a module (loaded once)."""
    import importlib.util
    mod = f"examples_torch_{name}"
    if mod not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            mod, os.path.join(ROOT, "examples_torch", f"{name}.py"))
        sys.modules[mod] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[mod])
    return sys.modules[mod]


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


# ------------------------------------------------------------ K5
def ssd_inputs(torch, cfg, B, S, seed):
    """A mamba2 block of ``cfg`` on the card, its biases, D and norm scale
    drawn away from 0 and 1 (which would hide terms), and its five
    projections' outputs for B x S random inputs."""
    from repro_torch.models import ssm as SSM
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = SSM.init_mamba(cfg, gen, torch.float32, "cuda")
    for k in ("conv_bx", "conv_bB", "conv_bC", "D", "norm_scale"):
        p[k] = p[k] + 0.1 * torch.randn(p[k].shape, generator=gen,
                                        device="cuda")
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    acts = tuple(x @ p[k] for k in ("in_z", "in_x", "in_B", "in_C",
                                    "in_dt"))
    return p, acts


def check_ssd_mixer(torch, cfg):
    """K5 against ``models.ssm.mixer_plain`` on the same inputs at each of
    SSD_CHECKS: the out_proj input and, where asked for, the final state
    within SSD_RTOL; one launch of each kernel a call (the state kernel
    only with a state).  Returns the largest max abs error."""
    from repro_torch.kernels import _build as KB
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import ssm as SSM
    worst = 0.0
    for B, S, chunk, state in SSD_CHECKS:
        c = dataclasses.replace(cfg, ssm_chunk=chunk)
        p, acts = ssd_inputs(torch, c, B, S, seed=S)
        h0 = 0.5 * torch.randn((B, c.ssm_heads, c.ssm_head_dim,
                                c.ssm_state), device="cuda") \
            if state else None
        with torch.no_grad():
            KB.LAUNCHES.clear()
            got, ghT = SSD.ssd_mixer(*acts, p, chunk=chunk, eps=c.norm_eps,
                                     h0=h0, want_state=state)
            torch.cuda.synchronize()
            launches = dict(KB.LAUNCHES)
            want, whT = SSM.mixer_plain(p, *acts, c, h0)
        assert launches == {k: 1 for k in SSD_KERNELS
                            if state or k != "ssd_state"}, launches
        assert (ghT is not None) == state
        errs = {}
        for what, g, w in (("out", got, want), ("hT", ghT, whT)):
            if g is None:
                continue
            errs[what] = max_err(g, w)
            top = float(w.abs().max())
            assert errs[what] <= SSD_RTOL * top, \
                f"ssd_mixer {what} max err {errs[what]} over the plain " \
                f"chain's max {top} at (B, S, chunk) {(B, S, chunk)}"
            worst = max(worst, errs[what])
        log(f"  ssd_mixer (B, S, chunk) {(B, S, chunk)}"
            f"{' from h0, state returned' if state else ''}: max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; launches {launches}")
    return worst


def ssd_work(cfg, B, S, state=False, h0=False):
    """(bytes moved, fp32 operations) of one K5 call at mamba2 ``cfg``'s
    widths, fp32: the mixer's own inputs read once (z, xr, Br, Cr, dt,
    the block's conv weights and biases, norm_scale, A_log, D, dt_bias,
    and h0 when given) and its outputs written once (out_proj's input,
    and the final state when ``state``); two operations an FMA of the
    convs, of C.B^T and (CB o L).(x dt) over the causal pairs of each
    chunk's real rows, and with a state of each row's state term B^T (x
    dt) and, in chunks that start from a state, of C.h.  The traffic
    through the kernels' workspaces is left out: it is the design's, not
    the mixer's."""
    di, N, H, P, K = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_head_dim, cfg.ssm_conv)
    Q = min(cfg.ssm_chunk, S)
    C = di + 2 * N  # the conv's channels
    hbytes = B * H * P * N
    nbytes = 4 * (B * S * (2 * di + 2 * N + H) + (K + 1) * C + di + 3 * H
                  + B * S * di + (hbytes if h0 else 0)
                  + (hbytes if state else 0))
    rows = [min(Q, S - c) for c in range(0, S, Q)]
    pairs = B * sum(r * (r + 1) // 2 for r in rows)
    ops = 2 * (B * S * C * K + pairs * (N + H * P))
    if state:
        from_state = S if h0 else S - rows[0]
        ops += 2 * B * (S + from_state) * H * P * N
    return nbytes, ops


def time_ssd_mixer(torch, cfg, inner, outer):
    """K5 and its plain chain at (1, S, d_model), S = 8 and 128: device ms
    a call (``device_ms``) beside ``ssd_work``'s bound."""
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import ssm as SSM
    out = {}
    for S in (8, 128):
        p, acts = ssd_inputs(torch, cfg, 1, S, seed=S)
        nbytes, ops = ssd_work(cfg, 1, S)
        with torch.no_grad():
            ms = device_ms(torch, lambda: SSD.ssd_mixer(
                *acts, p, chunk=cfg.ssm_chunk, eps=cfg.norm_eps), inner,
                outer)
            plain_ms = device_ms(torch, lambda: SSM.mixer_plain(
                p, *acts, cfg), inner, outer)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        out[S] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                  "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                  >= ops / FP32_OPS_PER_S else "operations",
                  "shape": [1, S, cfg.d_model]}
        log(f"  ssd_mixer (1, {S}, {cfg.d_model}): kernels {ms * 1e3:8.2f} "
            f"us  plain {plain_ms * 1e3:8.2f} us  bound "
            f"{bound * 1e3:6.3f} us ({out[S]['bound_by']}, "
            f"{100 * bound / ms:.1f}% of bound)")
    return out


# ------------------------------------------------------------ K6
def proj_inputs(torch, cfg, rows, seed, layers=1):
    """``layers`` mamba2 blocks' six projection weights of ``cfg`` on the
    card (a dict a block), the block input x (1, rows, d_model) and a
    mixer output g (1, rows, ssm_inner)."""
    from repro_torch.models import ssm as SSM
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ws = []
    for _ in range(layers):
        p = SSM.init_mamba(cfg, gen, torch.float32, "cuda")
        ws.append({k: p[k] for k in PROJ_IN + ("out_proj",)})
    x = torch.randn((1, rows, cfg.d_model), generator=gen, device="cuda")
    g = torch.randn((1, rows, cfg.ssm_inner), generator=gen, device="cuda")
    return ws, x, g


def proj_calls(torch, cfg, rows, seed, layers=1):
    """{entry: (kernel call, the plain products, one cuBLAS product)} of
    K6's two entry points at ``rows`` rows: the five input projections
    and out_proj; the library call of the five is one product against
    their weights side by side (made here).  Each call takes the next of
    ``layers`` blocks' weights: at a mamba2-130m's 24 (360 MB), a call
    finds its weights out of the card's 50 MB L2, as a served task's
    next layer does, while x and g, just written, lie in it."""
    from repro_torch.kernels import ssd_proj as PROJ
    ws, x, g = proj_inputs(torch, cfg, rows, seed, layers)
    ins = [tuple(w[k] for k in PROJ_IN) for w in ws]
    cats = [torch.cat(i, dim=1) for i in ins]
    outs = [w["out_proj"] for w in ws]
    turn = itertools.count()

    def nxt():
        return next(turn) % layers

    return {
        "ssd_in_proj": (lambda: PROJ.ssd_in_proj(x, *ins[nxt()]),
                        lambda: tuple(x @ t for t in ins[nxt()]),
                        lambda: torch.matmul(x, cats[nxt()])),
        "ssd_out_proj": (lambda: PROJ.ssd_out_proj(g, outs[nxt()]),
                         lambda: g @ outs[nxt()],
                         lambda: torch.matmul(g, outs[nxt()])),
    }, (x, g, ws)


def check_ssd_proj(torch, cfg):
    """K6 against the fp32 products (TF32 off) at each of PROJ_ROWS rows:
    within PROJ_RTOL, one launch a call, the same bits at a second call.
    Returns the largest max |d| over max |value|."""
    from repro_torch.kernels import _build as KB
    from repro_torch.kernels import ssd_proj as PROJ
    worst = 0.0
    for rows in PROJ_ROWS:
        calls, _ = proj_calls(torch, cfg, rows, seed=rows)
        for name, (kern, plain, _) in calls.items():
            with torch.no_grad():
                KB.LAUNCHES.clear()
                got = kern()
                torch.cuda.synchronize()
                launches = dict(KB.LAUNCHES)
                again = kern()
                want = plain()
            got, again = (t if isinstance(t, tuple) else (t,)
                          for t in (got, again))
            want = want if isinstance(want, tuple) else (want,)
            assert launches == {name: 1}, launches
            for g, a, w in zip(got, again, want):
                assert torch.equal(g, a), f"{name} repeats no bits"
                rel = max_err(g, w) / float(w.abs().max())
                assert rel <= PROJ_RTOL, \
                    f"{name} rows {rows}: max err over max {rel:.3g}"
                worst = max(worst, rel)
    log(f"  ssd_in_proj / ssd_out_proj at rows {PROJ_ROWS}: "
        f"max err over max {worst:.3g} (at most {PROJ_RTOL})")
    return worst


def proj_work(cfg, name, rows):
    """(bytes moved, fp32 operations) of one K6 call at mamba2 ``cfg``'s
    widths: the weights, x and the outputs each once; two operations a
    multiply-add."""
    d, di, N, H = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    K, n = (d, 2 * di + 2 * N + H) if name == "ssd_in_proj" else (di, d)
    return 4 * (K * n + rows * K + rows * n), 2 * rows * K * n


def time_ssd_proj(torch, cfg, rows, outer):
    """K6's entry points at ``rows`` rows: device ms a call
    (``device_ms``, four calls on each of ``cfg``'s layers' weights a
    graph, so that each call reads its weights from device memory) beside
    ``proj_work``'s bound, the plain products' ms (five for the input
    projections) and one cuBLAS product's (``library_ms``; the port never
    calls it)."""
    layers = cfg.num_layers
    inner = 4 * layers
    calls, _ = proj_calls(torch, cfg, rows, seed=rows, layers=layers)
    out = {}
    for name, (kern, plain, lib) in calls.items():
        nbytes, ops = proj_work(cfg, name, rows)
        with torch.no_grad():
            r = {"ms": device_ms(torch, kern, inner, outer),
                 "plain_ms": device_ms(torch, plain, inner, outer),
                 "library_ms": device_ms(torch, lib, inner, outer)}
        r["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                            ops / FP32_OPS_PER_S) * 1e3
        r["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / FP32_OPS_PER_S else "operations")
        r["shape"] = [rows, *((cfg.d_model, 2 * cfg.ssm_inner
                                + 2 * cfg.ssm_state + cfg.ssm_heads)
                               if name == "ssd_in_proj" else
                               (cfg.ssm_inner, cfg.d_model))]
        out[name] = r
        log(f"  {name} {r['shape']}: kernel "
            f"{r['ms'] * 1e3:7.2f} us  plain {r['plain_ms'] * 1e3:7.2f} us  "
            f"cuBLAS {r['library_ms'] * 1e3:7.2f} us  bound "
            f"{r['bound_ms'] * 1e3:6.3f} us ({r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound)")
    return out


def check_mixer_paths(paths, launches, what):
    """Every ``mamba_forward`` call that ``paths`` (``ssm.PATHS``) counted
    took the fused mixer; with ``launches``, as many launches of each
    kernel but the state kernel as calls."""
    paths = {k: v for k, v in paths.items() if v}
    log(f"{what}: mamba_forward paths {paths}")
    assert set(paths) == {"fused"}, \
        f"{what}: a mamba2 mixer call ran the plain chain on the card: " \
        f"{paths}"
    if launches is not None:
        for name in ("ssd_prep", "ssd_chunk", "gated_rmsnorm"):
            assert launches.get(name, 0) == paths["fused"], \
                f"{what}: {launches.get(name, 0)} {name} launches for " \
                f"{paths['fused']} fused mixer calls"


def check_proj_paths(paths, launches, what):
    """Every ``mamba_forward`` call that ``paths`` (``ssm.PROJ_PATHS``)
    counted as "fused" launched each projection kernel once, and serve's
    8-token tasks made some."""
    paths = {k: v for k, v in paths.items() if v}
    log(f"{what}: mamba_forward projection paths {paths}")
    assert paths.get("fused", 0) > 0, \
        f"{what}: no mamba2 projection ran on the projection kernels"
    for name in ("ssd_in_proj", "ssd_out_proj"):
        assert launches.get(name, 0) == paths["fused"], \
            f"{what}: {launches.get(name, 0)} {name} launches for " \
            f"{paths['fused']} fused projection calls"


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
    return [kind for kind, _ in graph_nodes(torch, fn)]


def graph_nodes(torch, fn):
    """(type, what) of each node of a CUDA graph captured from one call
    of ``fn``, read from the driver: for a kernel node its name (by
    ``cuFuncGetName`` / ``cuKernelGetName``; "?" where the driver gives
    none), for a copy node the bytes it copies, else None."""
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
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        what = None
        if kind.value == 0:
            what = kernel_node_name(cu, node)
        elif kind.value == 1:
            what = copy_node_bytes(cu, node)
        out.append((kind.value, what))
    del graph
    return out


def kernel_node_name(cu, node):
    """The name of a kernel node's function: CUDA_KERNEL_NODE_PARAMS_v2
    holds the CUfunction first and, for a kernel launched from a library,
    the CUkernel at byte 56."""
    import ctypes
    params = (ctypes.c_uint8 * 256)()
    name = ctypes.c_char_p()
    if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params) != 0:
        return "?"
    func = ctypes.c_void_p.from_buffer(params, 0).value
    kern = ctypes.c_void_p.from_buffer(params, 56).value
    if func and cu.cuFuncGetName(ctypes.byref(name),
                                 ctypes.c_void_p(func)) == 0:
        return name.value.decode()
    if kern and cu.cuKernelGetName(ctypes.byref(name),
                                   ctypes.c_void_p(kern)) == 0:
        return name.value.decode()
    return "?"


def copy_node_bytes(cu, node):
    """The bytes a copy node copies: CUDA_MEMCPY3D's WidthInBytes,
    Height and Depth, at bytes 176, 184 and 192 of the struct."""
    import ctypes
    params = (ctypes.c_uint8 * 256)()
    if cu.cuGraphMemcpyNodeGetParams(ctypes.c_void_p(node), params) != 0:
        return 0
    w, h, d = (ctypes.c_size_t.from_buffer(params, off).value
               for off in (176, 184, 192))
    return w * max(h, 1) * max(d, 1)


def profile_requests(torch, request, n):
    """Device busy time per request and the top kernels by device time.
    Returns (busy ms per request, idle share, kernel records per
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
        f"records/request")
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
    cloud step) through the jitted segments by ``steady_request``, and
    profiled twice more to diff the kernel-name histograms.  Returns
    (launches, the steady request's numbers, the profiler drift)."""
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

    # one steady request on the serve path: fused end step + cloud step,
    # through the jitted segments and through their bare functions
    eager = eager_twin(rt)

    def request(r=rt):
        pkt, _ = r.end_step_fused(toks, centers)
        return r.cloud_step(pkt)

    log("steady request (end segment + fused boundary + dequantize + "
        "cloud segment + head):")
    res = steady_request(torch, rt, request, lambda: request(eager))
    return launches, res, profile_drift(torch, request, 3)


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
    """``generate`` greedy from a seeded prompt (its prefill and decode
    step jitted); every new token is the argmax of the forward on the
    generated sequence (the forward is causal, so its logits at position i
    are those of the prefix up to i), or a near-tie: the forward's top-2
    logits within GEN_TIE_RTOL of the row's largest |logit|.  Then the
    decode steps one by one, each timed through a jitted step (the
    position a device tensor: one capture serves the 31 steps) and
    through the bare ``decode_step`` on the same inputs: the jitted
    logits against the bare ones by ``same_logits``, and all against the
    forward on their own sequence.  Returns (decode ms/token median
    jitted, the same eager, bound ms, all-weights bound ms, the jitted
    logits' difference from the eager ones, and a jitted step's device
    busy ms and idle share under torch.profiler)."""
    from repro_torch.core.jit import jit
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
        step = jit(functools.partial(M.decode_step, cfg=cfg))
        seq, step_logits, eager_logits, per, eager_per = \
            [prompt], [], [], [], []
        for t in range(new - 1):
            nxt = torch.argmax(lg, dim=-1)[:, None].to(prompt.dtype)
            seq.append(nxt)
            pos = torch.full((), prompt_len + t, dtype=torch.int32,
                             device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            elg, _ = M.decode_step(params, cfg, cache, nxt, prompt_len + t)
            torch.cuda.synchronize()
            eager_per.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            lg, cache = step(params, cache=cache, inputs=nxt, pos=pos)
            torch.cuda.synchronize()
            per.append(time.perf_counter() - t0)
            step_logits.append(lg)
            eager_logits.append(elg)
        assert (step.captures, step.replays) == (1, new - 1), \
            (step.captures, step.replays)
        # where a jitted step's time goes: device busy, idle share
        busy, idle, _ = profile_requests(torch, lambda: step(
            params, cache=cache, inputs=nxt, pos=pos), 3)
        step_logits = torch.cat(step_logits)
        jrel = same_logits(torch, step_logits, torch.cat(eager_logits),
                           f"{new - 1} jitted decode steps")
        seq = torch.cat(seq, dim=1)
        h, _, _ = M.forward(params, cfg, seq)
        want = M._lm_head(params, cfg, h[0, prompt_len:])
        rel = rel_err(torch, step_logits, want)
    assert rel < 1e-3, f"decode logits vs forward rel err {rel}"
    ms = statistics.median(per) * 1e3
    eager_ms = statistics.median(eager_per) * 1e3
    bound = decode_weight_bytes(cfg, params, M) / HBM_BYTES_PER_S * 1e3
    every = M.param_count(params) * 4 / HBM_BYTES_PER_S * 1e3
    log(f"generate {new} tokens after {prompt_len}: {gen_s:.3f}s; "
        f"{int(flips.sum())} near-tie flips; decode {ms:.3f} ms/token "
        f"jitted ({step.captures} capture, {step.replays} replays), "
        f"{eager_ms:.3f} eager (medians of {new - 1}) vs weight-bytes "
        f"bound {bound:.3f} ms (all weights {every:.3f} ms); decode vs "
        f"forward logits rel err {rel:.3g} (< 1e-3)")
    return ms, eager_ms, bound, every, jrel, busy, idle


# ------------------------------------------------------------ phase 9
def three_tier_runs(torch, cfg, params, device="cuda", executor=True):
    """The three-tier main path of ``examples/edge_tier.py`` on ``params``,
    24 requests a run, planned, its stream made and its ``classify`` built
    by the twin ``examples_torch/edge_tier.py`` (Jetson NX end, AGX Orin
    edge and A6000 cloud over 50 Mbps WiFi and the LAN backhaul): (a) the
    sync and async engines, each with ``classify`` through ``rt.run`` (the
    quantize kernel at both senders, the dequantize kernel at both
    receivers); with ``executor``, (b) ``AsyncHopPipeline`` running the
    runtime's fused segment handles (the fused boundary kernel at both
    intermediate segments, probes delivered through ``on_probe``) and (c)
    two tenants under wdrr, then each alone. The launch counts are set to 0
    just before and read just after these runs; every check that launches
    kernels comes after. Returns a dict of the runs' results."""
    from repro_torch.core.costs import (A6000_SERVER, EDGE_AGX_ORIN, ETH_LAN,
                                        JETSON_NX, WIFI_5GHZ,
                                        transformer_graph)
    from repro_torch.core.pipeline import TaskPlan
    from repro_torch.kernels import _build as KB
    from repro_torch.serving import (AsyncCoachEngine, AsyncHopPipeline,
                                     CoachEngine, MultiTenantCoachEngine,
                                     TenantSpec, VirtualClock)
    edge = example("edge_tier")
    devices = (JETSON_NX, EDGE_AGX_ORIN, A6000_SERVER)
    links = (WIFI_5GHZ(50.0), ETH_LAN())
    off, cuts, hop_bits, rt, _ = edge.plan_tier(
        cfg, params, transformer_graph(cfg, batch=1, seq=128), devices,
        links)
    log(f"plan: cuts {cuts} of {cfg.num_groups} groups, hop bits {hop_bits}, "
        f"max stage {off.times.max_stage * 1e3:.3f} ms (planner's profiles)")
    stream, calib = edge.make_stream(cfg, 0)
    tasks = stream.tasks(24)
    period = off.times.max_stage
    eng_kw = edge.engine_kwargs(cfg, links, hop_bits, calib)
    tokens, classify = edge.make_classify(rt, cfg, stream, device)

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


def eager_twin(rt):
    """``rt`` with its segment functions called bare, not jitted: the
    eager path that the CUDA graphs are held to."""
    twin = copy.copy(rt)
    twin._seg_fns = [f.fn for f in rt._seg_fns]
    return twin


def jit_counts(fns):
    """Captures, replays and copies summed over the distinct jitted
    functions in ``fns``."""
    fns = list({id(f): f for f in fns}.values())
    return tuple(sum(getattr(f, k) for f in fns)
                 for k in ("captures", "replays", "copies"))


def same_logits(torch, got, want, what):
    """``got`` bit-equal to ``want``, or within JIT_RTOL of it (max |d|
    over max |want|); returns the relative difference."""
    if torch.equal(got, want):
        log(f"  {what}: bit-equal to the eager functions'")
        return 0.0
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"  {what}: {rel:.3g} relative from the eager functions' (<= "
        f"{JIT_RTOL}; cause: a GEMM under capture runs on the capture "
        f"stream's cuBLAS handle, which may pick another algorithm)")
    assert rel <= JIT_RTOL, f"{what}: {rel} from the eager functions'"
    return rel


def steady_request(torch, rt, request, eager_request):
    """A steady ``request`` of ``rt`` (returning logits) through its
    jitted segments: the logits against ``eager_request``'s (the same
    request through the bare segment functions) by ``same_logits``; one
    graph replay a segment; host launches a request from the counters
    (graph replays, the jit's input copies and output clones, and the
    boundary kernels' launches); the kernel nodes of the eager request
    captured whole (the device work the graphs replay); the median wall
    ms of 10 requests (3 warm-up), then device busy and idle share under
    torch.profiler over 3.  The jit's captures must not move over the 10
    timed and 3 profiled requests."""
    from repro_torch.kernels import _build as KB
    with torch.no_grad():
        for _ in range(3):
            got = request()
        rel = same_logits(torch, got, eager_request(), "jitted request")
        torch.cuda.synchronize()
        caps, reps, cops = jit_counts(rt._seg_fns)
        kern = sum(KB.LAUNCHES.values())
        request()
        _, reps1, cops1 = jit_counts(rt._seg_fns)
        replays = reps1 - reps
        host = replays + cops1 - cops + sum(KB.LAUNCHES.values()) - kern
        assert replays == rt.n_segments, \
            f"{replays} graph replays a request, {rt.n_segments} segments"
        torch.cuda.synchronize()
        per = []
        for _ in range(10):
            t0 = time.perf_counter()
            request()
            torch.cuda.synchronize()
            per.append(time.perf_counter() - t0)
    req_ms = statistics.median(per) * 1e3
    busy, idle, records = profile_requests(torch, request, 3)
    assert jit_counts(rt._seg_fns)[0] == caps, \
        "the steady requests captured again"
    with torch.no_grad():
        nodes = sum(1 for t in graph_node_types(torch, eager_request)
                    if t == 0)
    log(f"  {req_ms:.2f} ms median of 10; {caps} captures, unchanged over "
        f"13 requests; {replays} graph replays a request; host launches a "
        f"request {host} (counters); kernel nodes a request {nodes} (the "
        f"eager request captured whole) + {cops1 - cops} jit copies")
    return {"request_ms": req_ms, "request_device_busy_ms": busy,
            "idle_share": idle, "profiler_kernel_records": records,
            "host_launches_per_request": host,
            "kernel_nodes_per_request": nodes,
            "jit_copies_per_request": cops1 - cops,
            "graph_replays_per_request": replays, "captures": caps,
            "jit_vs_eager_rel": rel}


# ------------------------------------------------------------ phase 10
# (n_micro, B_mb, S): the reference test's tokens, and enough rows (1024 a
# microbatch) for the two pods to have compute to overlap
PIPE_SHAPES = ((2, 4, 32), (8, 4, 256))
# each microbatch's max|d| / max|ref| against the monolithic forward, the
# reference test's bound (tests/test_collab.py:94-101)
PIPE_BOUND = 0.05
# the eager two-stream step's wall ms before it was jitted (PERF.md
# section 5), printed beside the jitted step's
PIPE_EAGER_BEFORE = {(2, 4, 32): "98.8-214.5 ms", (8, 4, 256): "594-864 ms"}


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
    amplification); the two-stream step under ``core.jit``: bit-equal to
    the three, host launches a step (graph replays, the jit's copies and
    kernel launches, from the counters) and the kernel nodes of the step
    captured whole; one step timed jitted, with the overlap and
    serialized, in turns, and the jit's captures unchanged over them;
    one serialized step profiled (kernel time and launches a step: the
    same kernels run in both modes).  Returns (launches, numbers)."""
    from repro_torch.core.collab import PodMesh, make_collab_pipeline_step
    from repro_torch.core.jit import jit
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
        jitted = jit(steps["overlap"])
        for _ in range(2):  # the capture's call, then a replay
            assert torch.equal(jitted(params, toks), out), \
                f"the jitted step differs from the eager one at {shape}"
        torch.cuda.synchronize()
        reps, cops = jitted.replays, jitted.copies
        kern = sum(KB.LAUNCHES.values())
        jitted(params, toks)
        host = jitted.replays - reps + jitted.copies - cops + \
            sum(KB.LAUNCHES.values()) - kern
        assert jitted.replays - reps == 1, "a jitted step replayed " \
            f"{jitted.replays - reps} graphs"
        nodes = sum(1 for t in graph_node_types(
            torch, lambda: steps["overlap"](params, toks)) if t == 0)
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
            "jit": lambda: jitted(params, toks),
            **{name: lambda s=steps[name]: s(params, toks)
               for name in ("overlap", "serial")}})
        assert jitted.captures == 1, \
            f"the jitted step captured {jitted.captures} times"
        # the same kernels run in both modes: one serialized step profiled
        log(f"  {shape} serialized, under the profiler:")
        busy, _, per_step = profile_requests(
            torch, lambda: steps["serial"](params, toks), 1)
    log(f"  {shape}: launches {launches}; jitted == two streams == one "
        f"stream == plain K3/K2; max|d|/max|ref| per microbatch "
        f"{', '.join(f'{r:.4g}' for r in rels)} (< {PIPE_BOUND}); "
        f"microbatch 0 rel L2: boundary {bnd:.4g}, logits {lg:.4g} "
        f"(amplification {lg / bnd:.3g})")
    log(f"  {shape} jitted: {jitted.captures} capture over every timed "
        f"step, 1 graph replay a step; host launches a step {host} "
        f"(counters); kernel nodes a step {nodes} (the eager step captured "
        f"whole)")
    for name, (wall, dev) in times.items():
        log(f"  {shape} {name:7s}: {wall:.2f} ms wall, {dev:.2f} ms between "
            f"device events (median of 6, in turns)")
    log(f"  {shape}: eager two-stream step before jit (PERF.md section "
        f"5): {PIPE_EAGER_BEFORE[shape]}")
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
        "jit_ms": times["jit"][0], "jit_event_ms": times["jit"][1],
        "jit_host_launches_per_step": host,
        "jit_kernel_nodes_per_step": nodes,
        "jit_captures": jitted.captures,
        "kernel_ms": busy, "launches_per_step": per_step}


# ------------------------------------------------------------ phase 11
def tree_to(torch, tree, device):
    from repro_torch.training.optim import tree_map
    return tree_map(lambda t: t.to(device), tree)


def train_card_vs_cpu(torch, M, cfg):
    """One train step's loss and gradients on the card against the CPU,
    on the same CPU-drawn weights and batch (B = 2, S = 64): loss within
    1e-5 relative, every gradient leaf within 1e-3 relative L2.  Returns
    (CPU params, card params, loss rel err, worst leaf rel L2)."""
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
    return params, gparams, lrel, worst


def train_jit_vs_eager(torch, M, cfg, params, rounds=6, mesh=None):
    """Three steps of the train step jitted with params and opt_state
    donated (``launch/train.py``'s step) against three eager donated
    steps, each side on its own card copy of ``params``, on the same
    batches (B = 2, S = 64): each loss, and every params, m and v leaf
    after the three, bit-equal or within JIT_RTOL (max |d| over max
    |ref|); ``step == 3``; one capture; the returned params and state the
    caller's tensors.  Then ``rounds`` more steps of each, in turns: the
    median wall ms a step (host clock to a synchronize) and the jit's
    captures unchanged over them.  With a ``mesh``, both sides run on
    DTensors in the FSDP layout on it, the hooks live (``core.jit`` on
    DTensor leaves).  Returns the numbers."""
    import contextlib
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core.jit import jit
    from repro_torch.launch import steps as ST
    from repro_torch.launch.sharding import (NamedSharding, batch_spec,
                                             distribute, layout_specs,
                                             shard_params)
    from repro_torch.models.shardctx import activation_sharding
    from repro_torch.training.optim import (AdamWConfig, adamw_init,
                                            tree_leaves, tree_map)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    layout = contextlib.ExitStack()
    if mesh is not None:
        layout.enter_context(activation_sharding(layout_specs(cfg, mesh,
                                                              2)))
        layout.enter_context(implicit_replication())

    def place(tree, batch=False):
        if mesh is None:
            return tree
        if batch:
            return distribute(tree, {k: NamedSharding(mesh, batch_spec(
                mesh, 2, 1)) for k in tree})
        return distribute(tree, shard_params(tree, mesh, cfg))

    gen = torch.Generator().manual_seed(21)

    def batch():
        toks = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                             generator=gen).to("cuda")
        return place({"tokens": toks, "labels": toks}, batch=True)

    def rel(a, w):
        a, w = full(a), full(w)
        return 0.0 if torch.equal(a, w) else float(
            (a - w).abs().max() / w.abs().max())

    with layout:
        mine, theirs = (place(tree_map(lambda t: t.to("cuda", copy=True),
                                       params)) for _ in range(2))
        opt, bare_opt = adamw_init(mine, opt_cfg), adamw_init(theirs,
                                                               opt_cfg)
        step = jit(ST.make_train_step(cfg, opt_cfg, donate=True),
                   donate=("params", "opt_state"))
        bare = ST.make_train_step(cfg, opt_cfg, donate=True)
        worst = 0.0
        for _ in range(3):
            b = batch()
            p2, o2, loss, _ = step(mine, opt, b)
            assert all(a is w for a, w in zip(tree_leaves((p2, o2)),
                                              tree_leaves((mine, opt)))), \
                "the jitted step returned a donated input as another tensor"
            _, _, want, _ = bare(theirs, bare_opt, b)
            worst = max(worst, rel(loss, want))
        after3 = int(opt.step)
        assert after3 == int(bare_opt.step) == 3, after3
        assert step.captures == 1, f"{step.captures} captures"
        for a, w in zip(tree_leaves((mine, opt.m, opt.v)),
                        tree_leaves((theirs, bare_opt.m, bare_opt.v))):
            worst = max(worst, rel(a, w))
        assert worst <= JIT_RTOL, f"jitted train step {worst} from the eager"
        walls = {"jit": [], "eager": []}
        calls = {"jit": lambda b: step(mine, opt, b),
                 "eager": lambda b: bare(theirs, bare_opt, b)}
        torch.cuda.synchronize()
        for r in range(rounds):
            b = batch()
            for name in (("jit", "eager") if r % 2 == 0
                         else ("eager", "jit")):
                t0 = time.perf_counter()
                calls[name](b)
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
        assert step.captures == 1, "the timed steps captured again"
        b = batch()
        nodes = node_counts(graph_nodes(torch, lambda: bare(theirs,
                                                             bare_opt, b)))
    ms = {k: statistics.median(v) for k, v in walls.items()}
    where = "" if mesh is None else ", DTensors in the FSDP layout on the " \
        "1x1 mesh"
    log(f"  {cfg.name} ({cfg.num_layers} layers{where}): 3 jitted donated "
        f"steps against 3 eager ones: loss and params/m/v "
        f"{'bit-equal' if worst == 0 else f'{worst:.3g} relative'}; step "
        f"{after3} after 3; {step.captures} capture; ms a "
        f"step (median of {rounds}, in turns) jitted {ms['jit']:.2f}, "
        f"eager {ms['eager']:.2f}; the step captured whole: {nodes}")
    return {"jit_vs_eager_rel": worst, "jit_ms": ms["jit"],
            "eager_ms": ms["eager"], "captures": step.captures,
            "graph": nodes}


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
    the card: fp32 params and AdamW state, remat, the step jitted and
    donated (captured at step 1, replayed at steps 2-5).  Every loss
    finite; ms per step (median of steps 2-5), tokens per second, peak
    memory (under the card's 80 GB), and the fp32 bound: 8 N flops a
    token (forward, its recompute, and a backward of twice the forward)
    at the card's fp32 peak."""
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
    assert peak < 80, f"peak {peak:.2f} GB"
    ms = statistics.median(secs[1:]) * 1e3
    bound = 8 * n * batch * seq / FP32_OPS_PER_S * 1e3
    log(f"  gemma2-2b full width ({get_config('gemma2-2b').num_layers} "
        f"layers, {n / 1e9:.3f} B, fp32): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; step ms "
        f"{', '.join(f'{x * 1e3:.1f}' for x in secs)} (median of 2-5: "
        f"{ms:.1f}); {batch * seq / ms * 1e3:.0f} tokens/s; peak "
        f"{peak:.2f} GB; fp32 bound {bound:.1f} ms ({100 * bound / ms:.1f}%); "
        f"eager before jit (PERF.md section 5): 1211.8-1271.4 ms, peak "
        f"54.22-54.73 GB")
    return {"losses": losses, "step_s": secs, "ms_per_step": ms,
            "tokens_per_s": batch * seq / ms * 1e3, "peak_gb": peak,
            "fp32_bound_ms": bound, "params": n}


# ------------------------------------------------------------ phase 12
# the dry-run pairs of phase 12 (b), on the 16x16 mesh of a fake group
DRYRUN_PAIRS = [["gemma2-2b", "train_4k"], ["mixtral-8x7b", "decode_32k"]]
# The reference's own dry-run of DRYRUN_PAIRS on the 16x16 mesh, per
# device: roofline flops, roofline collective bytes (both trip-count
# aware) and total_nonalias_bytes of its compiled program.  The card's
# machine has no JAX, so they are constants here, made with JAX 0.9.0
# (XLA's CPU backend, 256 fake host devices, the mesh's axes made Auto) by
#   python3 tools/dryrun_vs_reference.py gemma2-2b:train_4k \
#       mixtral-8x7b:decode_32k --side ref --json FILE
# (tests/test_torch_dryrun.py holds them to what the tool computes).
REFERENCE_DRYRUN = {
    "gemma2-2b train_4k": {"flops": 104838004211712.0,
                           "coll_bytes": 224890224128.0,
                           "memory_bytes": 4941252528.0},
    "mixtral-8x7b decode_32k": {"flops": 228033822720.0,
                                "coll_bytes": 211417640.0,
                                "memory_bytes": 18676442948.0},
}
# Likewise the reference's llama4-scout decode_32k on the 2x16x16 mesh
# (512 fake host devices), by the same command with --multi-pod: the pair
# whose ("pod", "data")-sharded weights DTensor gathered in two
# collectives (6.10x these collective bytes) before ``models/shardctx.py``
# gathered them in one over the flattened group.  Phase 12 (b) runs the
# port's side through the tool, with the card hidden, as on any host.
REFERENCE_DRYRUN_MULTI_POD = {
    "llama4-scout-17b-a16e decode_32k": {"flops": 250164183040.0,
                                         "coll_bytes": 1199518864.0,
                                         "memory_bytes": 6688802620.0},
}
# the port's figure over the reference's, at most
DRYRUN_TARGETS = {"flops": 1.3, "coll_bytes": 2.0, "memory_bytes": 2.0}
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
    steps through ``make_prefill_step`` / ``make_serve_step``, four ways
    on the same inputs: plain tensors eager and jitted, and the params as
    DTensors in the serving layout on the 1x1 card mesh with the hooks
    live, eager and jitted (``core.jit`` on DTensor leaves, the position
    a device tensor).  Every logit bit-equal to the plain eager steps';
    one capture of each jitted decode step for the 8 positions.  The
    jitted DTensor step's host launches a step come from its counters;
    its kernel and collective (NCCL) nodes from the eager DTensor step
    captured whole.  Returns the numbers."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.core.jit import jit
    from repro_torch.launch import steps as ST
    from repro_torch.launch.sharding import (NamedSharding, batch_spec,
                                             distribute, layout_specs,
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
    counts = {}

    def run(p, wrap, jitted):
        pf, st = (jit(prefill), jit(serve)) if jitted else (prefill, serve)
        logits, cache = pf(p, wrap(toks[:, :S]))
        outs, ms = [full(logits)], []
        for i in range(steps):
            pos = torch.full((), S + i, dtype=torch.int32, device="cuda") \
                if jitted else S + i
            x = wrap(toks[:, S + i:S + i + 1])
            torch.cuda.synchronize()
            before = st.replays + st.copies if jitted else 0
            t0 = time.perf_counter()
            logits, cache = st(p, cache, x, pos)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if jitted:
                counts["host_launches"] = st.replays + st.copies - before
            outs.append(full(logits))
        if jitted:
            assert (pf.captures, st.captures, st.replays) == (1, 1, steps), \
                f"jitted prefill / decode: {pf.captures} / {st.captures} " \
                f"captures, {st.replays} decode replays for {steps} steps"
        # the first jitted step warms up and captures: the median of the
        # 7 after it, and of all 8 eager steps
        return outs, statistics.median(ms[1:] if jitted else ms), cache

    def same(got, want):
        return all(torch.equal(g, w) for g, w in zip(got, want)), max(
            float((g - w).abs().max()) for g, w in zip(got, want))

    with torch.no_grad():
        want, ms_plain, _ = run(params, lambda x: x, False)
        got_pj, ms_plain_jit, _ = run(params, lambda x: x, True)
        with activation_sharding(layout_specs(cfg, mesh, B)), \
                implicit_replication():
            dp = distribute(params, shard_params(params, mesh, cfg,
                                                 serving=True))

            def wrap(x):
                return distribute(x, NamedSharding(mesh, batch_spec(
                    mesh, B, 1)))

            got, ms_dt, cache = run(dp, wrap, False)
            got_j, ms_dt_jit, _ = run(dp, wrap, True)
            x = wrap(toks[:, -1:])
            pos = torch.full((), S + steps - 1, dtype=torch.int32,
                             device="cuda")
            nodes = node_counts(graph_nodes(torch, lambda: serve(
                dp, cache, x, pos)))
        _, cache = prefill(params, toks[:, :S])
        plain = node_counts(graph_nodes(torch, lambda: serve(
            params, cache, toks[:, S:S + 1], pos)))
    checks = {"DTensor eager": same(got, want),
              "DTensor jitted": same(got_j, want),
              "plain jitted": same(got_pj, want)}
    worst = max(w for _, w in checks.values())
    log(f"  gemma2-2b full width, serving layout on the 1x1 mesh: prefill "
        f"+ {steps} decode steps of B = {B}, logits against the plain eager "
        f"steps: " + ", ".join(f"{k} bit-equal {e} (max |d| {w:.3g})"
                               for k, (e, w) in checks.items()))
    log(f"  decode ms a step: plain eager {ms_plain:.2f}, plain jitted "
        f"{ms_plain_jit:.2f}, DTensor eager {ms_dt:.2f}, DTensor jitted "
        f"{ms_dt_jit:.2f} (one capture each for the {steps} positions; "
        f"jitted: median of the {steps - 1} steps after the capture); "
        f"jitted DTensor step: {counts['host_launches']} host launches a "
        f"step (counters: 1 replay + input copies and output clones); the "
        f"step captured whole, DTensor {nodes} (plain {plain})")
    assert all(e for e, _ in checks.values()), \
        f"DTensor or jitted logits differ from the plain ones: {checks}"
    return {"max_abs_diff": worst, "decode_ms_plain": ms_plain,
            "decode_ms_plain_jit": ms_plain_jit, "decode_ms_dtensor": ms_dt,
            "decode_ms_dtensor_jit": ms_dt_jit,
            "host_launches_per_step_dtensor_jit": counts["host_launches"],
            "graph_dtensor": nodes, "graph_plain": plain}


def node_counts(nodes):
    """``graph_nodes``' nodes counted: kernels, NCCL collectives among
    them, copies and the bytes they copy, and all."""
    return {"kernels": sum(1 for t, _ in nodes if t == 0),
            "nccl": sum(1 for t, n in nodes if t == 0 and "nccl" in
                        n.lower()),
            "copies": sum(1 for t, _ in nodes if t == 1),
            "copy_bytes": sum(n for t, n in nodes if t == 1),
            "all": len(nodes)}


def dtensor_train_check(torch, M, mesh):
    """One train step's loss and gradients of full-width gemma2-2b cut
    to 4 layers (phase 11's step, B = 2, S = 64) in the FSDP layout on the
    1x1 card mesh against plain tensors: loss bit-equal, every gradient
    leaf within 1e-6 relative L2; then ``train_jit_vs_eager`` on DTensors
    in that layout.  Returns (loss rel, worst leaf, the jitted steps'
    numbers)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.launch.sharding import (NamedSharding, batch_spec,
                                             distribute, layout_specs,
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
    with activation_sharding(layout_specs(cfg, mesh, 2)), \
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
    dp = grads = dgrads = None
    jitted = train_jit_vs_eager(torch, M, cfg, params, rounds=4, mesh=mesh)
    return lrel, worst, jitted


def dryrun_check():
    """``launch.dryrun`` of DRYRUN_PAIRS on the 16x16 mesh of a fake
    256-rank group, in a subprocess of its own, and beside it
    ``tools/dryrun_vs_reference.py --side port --multi-pod`` on the pairs
    of REFERENCE_DRYRUN_MULTI_POD (a fake 512-rank group): per device the
    flops, HBM bytes, collective bytes by kind, the roofline terms and
    the trace seconds; each pair's flops, collective bytes and memory
    held to DRYRUN_TARGETS against the reference's."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=SRC)
    single = subprocess.Popen([sys.executable, "-c", _DRYRUN,
                               json.dumps(DRYRUN_PAIRS)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "multi_pod.json")
        multi = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "dryrun_vs_reference.py"),
             *[p.replace(" ", ":") for p in REFERENCE_DRYRUN_MULTI_POD],
             "--multi-pod", "--side", "port", "--json", path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            out, err = single.communicate(timeout=300)
            assert single.returncode == 0, f"the dry-run failed: {err[-3000:]}"
            mout, merr = multi.communicate(timeout=300)
            assert multi.returncode == 0, \
                f"the multi-pod dry-run failed: {mout[-2000:]} {merr[-2000:]}"
            with open(path) as f:
                mreps = json.load(f)
        finally:
            for proc in (single, multi):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    reps = [(pair, rep, REFERENCE_DRYRUN[pair]) for pair, rep in
            json.loads(out.strip().splitlines()[-1]).items()]
    reps += [(pair, mreps[pair]["port"],
              REFERENCE_DRYRUN_MULTI_POD[pair]) for pair in mreps]
    results = {}
    for pair, rep, reference in reps:
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
        got = {"flops": roof["flops"], "coll_bytes": roof["coll_bytes"],
               "memory_bytes": rep["memory"]["total_nonalias_bytes"]}
        ratio = {k: got[k] / reference[k] for k in got}
        log(f"    against the reference's dry-run: " + ", ".join(
            f"{k} {got[k]:.4g} / {reference[k]:.4g} = "
            f"{ratio[k]:.3f}x (<= {DRYRUN_TARGETS[k]})" for k in got))
        assert all(ratio[k] <= DRYRUN_TARGETS[k] for k in ratio), \
            f"{pair} outside the targets against the reference: {ratio}"
        results[f"{pair} {rep['mesh']}"] = dict(
            {k: rep[k] for k in ("trace_s", "memory", "cost", "collectives",
                                 "roofline", "useful_flop_frac")},
            against_reference=ratio)
    return results


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


# ------------------------------------------------------------ phase 13
def quickstart_check(torch):
    """``examples_torch/quickstart.py`` run on the card as a user runs it
    (its ``main``, on reduced gemma2-2b): the quantize kernel at its end
    step, the dequantize kernel at its cloud step and the probe kernel at
    ``rt.probe`` each launched (the wrappers' counters, set to 0 just
    before and read just after); the split within SPLIT_BOUND[8] of the
    monolithic model; a finite separability and one choice for each of
    its 4 tasks.  Returns (launches, numbers)."""
    from repro_torch.kernels import _build as KB
    KB.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = example("quickstart").main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(KB.LAUNCHES)
    log(f"quickstart in {wall:.2f} s; launches {launches}")
    for name in ("uaq_quantize", "uaq_dequantize", "semantic_probe"):
        assert launches.get(name, 0) > 0, f"quickstart never launched {name}"
    seps = [c[0] for c in res["choices"]]
    assert res["rel_err"] < SPLIT_BOUND[8], res
    assert len(seps) == 4 and all(math.isfinite(v) for v in seps), res
    return launches, dict(res, wall_s=wall)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")) or \
            not os.path.isdir(os.path.join(ROOT, "examples_torch")):
        print(f"chip_smoke: {SRC}/repro_torch or {ROOT}/examples_torch not "
              f"found; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build as KB
    from repro_torch.kernels import boundary, ref, semantic_cache, uaq
    from repro_torch.models import model as M
    from repro_torch.models import ssm as SSM
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
    ssd_err = check_ssd_mixer(torch, get_config("mamba2-130m"))
    proj_err = check_ssd_proj(torch, get_config("mamba2-130m"))
    log(f"all kernels agree ({time.time() - t0:.1f}s); max abs err {errs}, "
        f"ssd_mixer {ssd_err:.3g}, ssd_proj (over max) {proj_err:.3g}")

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
    t_ssd = time_ssd_mixer(torch, get_config("mamba2-130m"), inner=200,
                           outer=20)
    t_proj = time_ssd_proj(torch, get_config("mamba2-130m"), 8, outer=20)
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
    second_launches, res, drift = runtime_check(torch, cfg, params,
                                                SPLIT_BOUND)
    add_launches(second_launches)
    results["gemma2-2b"] = dict(res, serve_wall_s=wall,
                                profiler_drift=drift)

    for phase, name, cfg in (
            (6, "mamba2-130m", get_config("mamba2-130m")),
            (7, "mixtral-8x7b", dataclasses.replace(
                get_config("mixtral-8x7b"), num_layers=4))):
        log(f"== phase {phase}: serve 24 requests, the unfused hop and the "
            f"probe on full-width {name} ({cfg.num_layers} layers)")
        params = None  # the previous phase's weights go first
        torch.cuda.empty_cache()
        params = init_params(torch, M, cfg)
        SSM.PATHS.clear()
        SSM.PROJ_PATHS.clear()
        lw, wall = serve_check(torch, name, params)
        add_launches(lw)
        if name == "mamba2-130m":
            check_mixer_paths(SSM.PATHS, lw, "serve")
            check_proj_paths(SSM.PROJ_PATHS, lw, "serve")
        SSM.PATHS.clear()
        lr, res, drift = runtime_check(torch, cfg, params,
                                       SPLIT_BOUND_SCALED)
        add_launches(lr)
        if name == "mamba2-130m":
            check_mixer_paths(SSM.PATHS, None, "runtime")
        results[name] = dict(res, layers=cfg.num_layers, serve_wall_s=wall,
                             profiler_drift=drift)

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
        ms, eager_ms, bound, every, jrel, busy, idle = generation_check(
            torch, gcfg, params)
        results[name].update(decode_ms_per_token=ms,
                             decode_eager_ms_per_token=eager_ms,
                             decode_bound_ms=bound,
                             decode_all_weights_ms=every,
                             decode_jit_vs_eager_rel=jrel,
                             decode_device_busy_ms=busy,
                             decode_idle_share=idle)
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
    eager = eager_twin(rt)
    res.update(steady_request(torch, rt, lambda: rt.run(toks)[0],
                              lambda: eager.run(toks)[0]))
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
    log(" (a) one train step, card against CPU; the jitted donated step "
        "against the eager one")
    res = {}
    for cfg in (dataclasses.replace(get_config("gemma2-2b"), num_layers=4),
                get_config("mamba2-130m")):
        cparams, gparams, lrel, worst = train_card_vs_cpu(torch, M, cfg)
        res[f"{cfg.name} {cfg.num_layers} layers"] = dict(
            train_jit_vs_eager(torch, M, cfg, cparams), loss_rel=lrel,
            worst_grad_rel_l2=worst)
        cparams = None
        torch.cuda.empty_cache()
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
    serve_res = dtensor_serve_check(torch, M, mesh)
    torch.cuda.empty_cache()
    lrel, gworst, train_jit = dtensor_train_check(torch, M, mesh)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(" (b) the dry-run on the 16x16 and 2x16x16 meshes and (c) the "
        "reduced train steps on a fake 4x4 mesh (three subprocesses side "
        "by side)")
    probe = probe_start()
    try:
        dryrun = dryrun_check()
    except BaseException:
        probe.kill()
        probe.wait()
        raise
    probe_secs = probe_check(probe)
    results["dtensor"] = {
        "serve": serve_res, "train_loss_rel": lrel,
        "train_worst_grad_rel_l2": gworst, "train_jit": train_jit,
        "dryrun": dryrun, "train_4x4_s": probe_secs}
    log(f"phase 12 in {time.time() - t12:.1f}s (budget 60 s)")

    log("== phase 13: examples_torch/quickstart.py on the card")
    lq, results["quickstart"] = quickstart_check(torch)
    add_launches(lq)

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
    assert launches.get("ssd_prep", 0) > 0, "the SSD mixer never launched"
    kernels.append({
        "name": "ssd_mixer", "route": "cuda", "source": SSD_SOURCE,
        "replaces": f"no pallas_call: XLA fuses {SSD_PLAIN}'s chain",
        "launches": int(launches["ssd_prep"]),
        "launches_by_kernel": {k: int(launches.get(k, 0))
                               for k in SSD_KERNELS},
        "max_abs_err": ssd_err, "ms": t_ssd[8]["ms"],
        "plain_ms": t_ssd[8]["plain_ms"], "bound_ms": t_ssd[8]["bound_ms"],
        "bound_by": t_ssd[8]["bound_by"], "library_ms": None,
        "shape": t_ssd[8]["shape"], "s128": t_ssd[128],
    })
    for name in ("ssd_in_proj", "ssd_out_proj"):
        assert launches.get(name, 0) > 0, f"{name} never launched"
        kernels.append(dict(
            t_proj[name], name=name, route="cuda", source=PROJ_SOURCE,
            replaces=f"no pallas_call: XLA runs {PROJ_PLAIN}'s dots",
            launches=int(launches[name]), max_rel_err=proj_err))
    log(json.dumps({"phases": results}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
