"""The pipelined step's cell (``drivers/pipe_step.py``): the dense
reference against the port, its flops, its per-layer readers, and whole
runs.

On the CPU the port's step cannot run (its pods are CUDA streams), so a
run there drives the window, the counters and the comparison through a
stand-in built from the port's own pieces as the step composes them,
with the plain K3 / K2.  On the card (``gpu``) the runs are of the cell
itself, at its own size."""

import gc
import math
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.drivers import pipe_step as PS
from perfbench.flops import dense as FD
from perfbench.harness import main as MAIN
from perfbench.harness import weights as W
from perfbench.harness.served import port_config
from perfbench.reference import dense as RD
from perfbench.tests.tiny import (bench, cell_files, composed, on_the_cpu,
                                  tiny_conf, tiny_traffic)

CELL = "pipe-qwen3-14b-bf16-2x1x512"
TINY_TRAFFIC = dict(n_micro=4, batch=2, seq_len=16)


def tiny(dtype="float32"):
    """The cell's files at the tiny widths, in ``dtype``."""
    cell, conf, traffic, limits = cell_files(CELL)
    conf = tiny_conf(conf)
    conf["dtype"] = dtype
    return cell, conf, dict(tiny_traffic(traffic), **TINY_TRAFFIC), limits


# ------------------------------------------------------------ reference
@pytest.mark.parametrize("seq_len", [8, 48])
def test_dense_reference_agrees_with_the_port(seq_len):
    from repro_torch.models import model as M
    _, conf, _, _ = tiny()
    cfg, model = port_config(conf), conf["model"]
    params = W.make(M.init_params(cfg, device="meta"), 11, "cpu")
    toks = torch.randint(0, model["vocab_size"], (3, seq_len),
                         generator=torch.Generator().manual_seed(seq_len))
    with torch.no_grad():
        h, _, _ = M.forward(params, cfg, toks)
        want = M._lm_head(params, cfg, h[:, -1])
        got = RD.forward(params, model, toks, range(model["num_layers"]),
                         first=True, last=True)
        assert (got - want).abs().max() / want.abs().max() < 2e-5
        split = conf["deployment"]["layers_per_pod"]
        for bits in (8, 4):
            want = composed(cfg, bits)(params, toks[None])[0]
            got = RD.pipeline(params, model, toks, split, bits)
            assert (got - want).abs().max() / want.abs().max() < 2e-5


def test_the_dense_reference_imports_nothing_of_the_program():
    import os
    import subprocess
    import sys

    from perfbench.tests.tiny import ROOT
    code = ("import sys\n"
            f"sys.path[:0] = [{ROOT!r}]\n"
            "import perfbench.reference.dense, perfbench.flops.dense\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'repro', 'repro_torch')))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_fp8_operands_round_by_rows_and_columns():
    a = torch.randn(5, 64, generator=torch.Generator().manual_seed(1))
    b = torch.randn(64, 7, generator=torch.Generator().manual_seed(2)) * 1e3
    exact = a @ b
    got = RD.mm(a, b, RD.FP8)
    rel = float((got - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.1   # e4m3's 3 mantissa bits, not 0 and not off
    assert torch.equal(RD.mm(a, b, torch.float32), exact)
    # one scale a row of a: a row scaled by 2**10 rounds alike
    a2 = a.clone()
    a2[0] *= 1024.0
    assert torch.equal(RD._round8(a2, -1)[0], RD._round8(a, -1)[0] * 1024.0)


# ---------------------------------------------------------------- flops
@pytest.mark.parametrize("seq_len", [8, 40])
def test_dense_flops(seq_len):
    from repro_torch.models import model as M
    _, conf, _, _ = tiny()
    m = conf["model"]
    params = W.make(M.init_params(port_config(conf), device="meta"), 7,
                    "cpu")
    toks = torch.randint(0, m["vocab_size"], (1, seq_len))
    with FlopCounterMode(display=False) as fc:
        RD.forward(params, m, toks, range(m["num_layers"]), first=True,
                   last=True)
    # the reference scores every key and masks; the formula counts the
    # causal ones
    masked = m["num_layers"] * 4 * m["num_heads"] * m["head_dim"] * (
        seq_len * seq_len - seq_len * (seq_len + 1) // 2)
    assert fc.get_total_flops() == FD.task_flops(m, seq_len) + masked


def test_full_size_step_flops():
    """The cell's step, 2 requests of 1 x 512: 27.06 TFLOP in the
    projections and MLPs, 0.22 in attention, 0.003 in the head: 2 x
    parameters a token, plus the causal pairs."""
    m = cell_files(CELL)[1]["model"]
    per_token = 2 * 40 * (5120 * (40 + 16) * 128 + 40 * 128 * 5120
                          + 3 * 5120 * 17408)
    attn = 40 * 4 * 40 * 128 * 512 * 513 // 2
    want = 2 * (512 * per_token + attn + 2 * 5120 * 151936)
    got = FD.step_flops(m, 2, 1, 512)
    assert got == want
    assert 27.27e12 < got < 27.28e12
    assert 27.05e12 < 1024 * per_token < 27.06e12


# ------------------------------------------------------------- readers
def test_task_mfu_reads_the_driver_peak():
    """A step over the bf16 peak, a served task over the fp32 one: the
    driver's ``peak_flops`` for its configuration's dtype."""
    from perfbench.harness.window import Record
    from perfbench.harness.work import PEAK_FLOPS
    from perfbench.metrics import task_mfu
    recs = [Record(i, None, start=i * 1.0, end=i * 1.0 + 0.5, ok=True)
            for i in range(4)]
    recs.append(Record(4, None, start=4.0, ok=False))
    for dtype, peak in (("bfloat16", 989.4e12), ("float32", 67e12)):
        run = MAIN.Run(records=recs, flops_per_task=27.5e12,
                       peak_flops=PEAK_FLOPS[dtype])
        assert task_mfu.read(run) == pytest.approx(
            100 * 27.5e12 / (0.5 * peak))
    assert task_mfu.read(MAIN.Run(records=recs[4:], flops_per_task=1.0,
                                  peak_flops=1.0)) is None


def test_the_hop_kernels_bounds_at_the_cells_shape():
    """One K3 or K2 call on the hop: a request's 512 rows of 5120 bf16
    channels against its 8-bit wire (a byte a channel, 8 of scale and
    zero point a row)."""
    from perfbench.harness.work import PEAK_HBM_BYTES, roofline_s
    rows, D = 512, 5120
    wire = rows * (D + 8)
    for name in ("uaq_quantize", "uaq_dequantize"):
        assert roofline_s(name, 1, rows, D, 0, 8, 2) == pytest.approx(
            (wire + 2 * rows * D) / PEAK_HBM_BYTES)
        # the served split's fp32 activations, as before the ``act`` term
        assert roofline_s(name, 1, 128, 768, 0, 8) == roofline_s(
            name, 1, 128, 768, 0, 8, 4)


def test_concurrent_time_counts_two_or_more_in_flight():
    from perfbench.harness.trace import concurrent_ns
    assert concurrent_ns([(0, 10, "a"), (5, 15, "b"), (10, 20, "c"),
                          (12, 13, "d")]) == 10
    assert concurrent_ns([(0, 10, "a"), (10, 20, "b")]) == 0
    assert concurrent_ns([(0, 10, "a"), (2, 4, "b"), (3, 8, "c")]) == 6
    assert concurrent_ns([]) == 0


# -------------------------------------------------------- runs on the CPU
def cpu_run(monkeypatch, fault=None, seed=5, seconds=1.0):
    """A tiny run on one thread, as ``run.py`` runs (a window of a few
    steps at least, so that every tick position is compared)."""
    on_the_cpu("pipe_step", monkeypatch)
    cell, conf, traffic, limits = tiny()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return MAIN.execute(bench(), cell, conf, traffic, limits, seed,
                            seconds, False, torch.device("cpu"), time.time(),
                            fault=fault)
    finally:
        torch.set_num_threads(threads)


def test_a_cpu_run_of_the_stand_in_is_correct(monkeypatch):
    out = cpu_run(monkeypatch)
    lines = out.pop("_lines")
    assert out["correct"] is True, lines
    assert out["failed"] == 0 and out["attempted"] >= TINY_TRAFFIC["n_micro"]
    assert set(out["checks"]) == set(PS.NUMBERS)
    assert set(out["metrics"]) == {m["name"] for m in bench()["end_to_end"]
                                   if MAIN.applies(m, CELL)} \
        == {"tokens_per_s.device_bound", "setup_s"}


def test_every_per_layer_reader_reads_a_traced_window(monkeypatch):
    """The driver's fields after a tiny window of the stand-in, with a
    trace of the kernels the readers look for: each of the cell's
    per-layer metrics reads a number (host launches read 0 here: on the
    CPU the jitted step is the bare function)."""
    import importlib

    from perfbench.harness import window as WIN
    on_the_cpu("pipe_step", monkeypatch)
    _, conf, traffic, _ = tiny()
    drv = PS.Driver(conf, traffic, 5, torch.device("cpu"))
    mark = drv.mark()
    w = WIN.run(drv, 5, 0.5, None, False)
    problem, _, fields = drv.after_window(mark, w["records"], (1, 3))
    assert problem is None
    assert fields["rows"] == TINY_TRAFFIC["batch"] * TINY_TRAFFIC["seq_len"]
    assert fields["act_bytes"] == 4 and fields["wire_bits"] == 8
    trace = {"busy_s": 0.02, "overlap_s": 0.005, "window_s": 0.05,
             "kernels": {"uaq_quantize_rows_kernel<__nv_bfloat16>": (3e-5, 4),
                         "dequant_kernel<__nv_bfloat16>": (3e-5, 4)}}
    run = MAIN.Run(records=w["records"], window_s=w["t1"] - w["t0"],
                   setup_s=1.0, trace=trace, trace_range=(1, 3), **fields)
    metrics = [m for m in bench()["per_layer"] if MAIN.applies(m, CELL)]
    assert {m["name"].split(".")[0] for m in metrics} == {
        "host_launches_per_task", "task_mfu", "uaq_dequantize_roofline",
        "uaq_quantize_roofline", "idle_share", "pod_overlap_share"}
    for m in metrics:
        reader = importlib.import_module(
            f"perfbench.metrics.{m['name'].split('.')[0]}")
        v = reader.read(run)
        assert v is not None and math.isfinite(v), m["name"]
        assert v > 0 or m["name"].startswith("host_launches"), m["name"]
    drv.close()


def zero_micro(drv):
    """One microbatch's answer altered where it is produced."""
    step = drv.step

    def broken(params, tokens):
        out = step(params, tokens)
        out[drv.n_micro // 2] = 0
        return out
    drv.step = broken


def stale_tick(drv):
    """Each microbatch answered with the one before it: pod 1 a tick
    behind pod 0."""
    step = drv.step
    drv.step = lambda params, tokens: step(params, tokens).roll(1, dims=0)


@pytest.mark.parametrize("fault", [zero_micro, stale_tick, PS.wire(4)])
def test_a_broken_step_is_not_correct_on_the_cpu(monkeypatch, fault):
    out = cpu_run(monkeypatch, fault=fault)
    lines = out.pop("_lines")
    assert out["correct"] is False, lines
    assert any("OVER" in line for line in lines)


def test_the_fp8_control_is_not_correct():
    cell, conf, traffic, limits = tiny()
    numbers, ok, lines = PS.CONTROLS["float8_e4m3fn"](
        bench(), cell, conf, traffic, limits, 3, 1.0, 20,
        torch.device("cpu"))
    assert not ok, lines


def test_every_compared_tick_position_is_a_microbatch_of_its_step():
    toks = {i: np.full((4, 2, 3), i * 10) + np.arange(4)[:, None, None]
            for i in range(9)}
    got = PS.sampled_tokens([7, 2, 5, 8, 1], toks.__getitem__, 4)
    assert got.shape == (10, 3)
    assert list(got[::2, 0]) == [70, 21, 52, 83, 10]


# ------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's pods are CUDA streams")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()


def card_run(dev, fault=None, seed=11, seconds=5.0):
    cell, conf, traffic, limits = cell_files(CELL)
    return MAIN.execute(bench(), cell, conf, traffic, limits, seed, seconds,
                        False, dev, time.time(), fault=fault)


@pytest.mark.gpu
def test_a_short_window_on_the_card_is_correct(card):
    out = card_run(card)
    assert not isinstance(out, int), f"the window broke a rule (code {out})"
    lines = out.pop("_lines")
    assert out["correct"] is True, lines
    assert out["failed"] == 0 and out["attempted"] >= 3
    assert math.isfinite(out["metrics"]["tokens_per_s.device_bound"]["value"])


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [zero_micro, PS.wire(4)])
def test_a_broken_step_on_the_card_is_not_correct(card, fault):
    out = card_run(card, fault=fault)
    lines = out.pop("_lines")
    assert out["correct"] is False, lines


@pytest.mark.gpu
def test_launches_are_the_jits_counters(card):
    from perfbench.harness import window as WIN
    from repro_torch.kernels import _build as KB
    _, conf, traffic, _ = cell_files(CELL)
    drv = PS.Driver(conf, traffic, 13, card)
    assert drv.capture_launches == {k: 2 * drv.n_micro
                                    for k in PS.WIRE_KERNELS}
    mark = drv.mark()
    j = drv.jitted
    r0, c0, k0 = j.replays, j.copies, sum(KB.LAUNCHES.values())
    w = WIN.run(drv, 13, 2.0, None, False)
    problem, _, fields = drv.after_window(mark, w["records"], None)
    assert problem is None and j.captures == 1
    n = len(w["records"])
    assert fields["launches"] == j.replays - r0 + j.copies - c0 \
        + sum(KB.LAUNCHES.values()) - k0 == 3 * n
    assert j.replays - r0 == n
    drv.close()
