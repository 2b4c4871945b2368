"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped): the result line's keys, the metrics a cell reports, and
``correct``; then the run with the program broken underneath, once for
each fault the cells can have, and ``correct`` false."""

import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench.harness import main as MAIN
from perfbench.tests.tiny import (ROOT, bench, cell_files, tiny_conf,
                                  tiny_traffic)

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def tiny_run(cell_name, seq_len=None, seconds=1.0, fault=None, seed=5):
    cell, conf, traffic, limits = cell_files(cell_name)
    return MAIN.execute(bench(), cell, tiny_conf(conf),
                        tiny_traffic(traffic, seq_len), limits, seed,
                        seconds, False, torch.device("cpu"), time.time(),
                        fault=fault)


@pytest.mark.parametrize("cell,seq_len", [
    ("serve-mamba2-130m-s8-closed", None),
    ("serve-mixtral-8x7b-4l-s8-poisson", None),
    ("serve-mamba2-130m-s128-closed", 32),
    ("serve-mixtral-8x7b-4l-s128-closed", 32)])
def test_a_run_has_the_contracts_keys_and_is_correct(cell, seq_len):
    out = tiny_run(cell, seq_len)
    lines = out.pop("_lines")
    assert list(out) == KEYS  # no trace: no breakdown; checks last
    assert out["correct"] is True, lines
    assert out["failed"] == 0 and out["attempted"] >= 3
    b = bench()
    want = {m["name"] for m in b["end_to_end"] if MAIN.applies(m, cell)}
    assert set(out["metrics"]) == want
    assert "setup_s" in want and len(want) >= 2
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["checks"]) == set(cell_files(cell)[3]["limits"])
    json.dumps(out)


def break_logits(served):
    rt = served.rt
    cloud = rt.cloud_step
    rt.cloud_step = lambda pkt: cloud(pkt) * 1.01


def break_packet(served):
    rt = served.rt
    end = rt.end_step_fused

    def step(inp, centers, bits=None):
        pkt, probe = end(inp, centers, bits)
        pkt.payload = pkt.payload ^ 1
        return pkt, probe
    rt.end_step_fused = step


def freeze_scheduler(served):
    """The scheduler's state never changes: its cache drops updates."""
    served.engine.sched.cache.update = lambda feat, label: None


def break_probe(served):
    """The probe's answer altered where it is produced."""
    rt = served.rt
    end = rt.end_step_fused

    def step(inp, centers, bits=None):
        pkt, probe = end(inp, centers, bits)
        probe.sims[:] = probe.sims.flip(-1)
        return pkt, probe
    rt.end_step_fused = step


@pytest.mark.parametrize("cell,seq_len", [
    ("serve-mixtral-8x7b-4l-s8-poisson", None),
    ("serve-mamba2-130m-s8-closed", None)])
@pytest.mark.parametrize("fault", [break_logits, break_packet,
                                   freeze_scheduler, break_probe])
def test_a_broken_program_is_not_correct(cell, seq_len, fault):
    out = tiny_run(cell, seq_len, fault=fault)
    lines = out.pop("_lines")
    assert out["correct"] is False, lines
    assert any("OVER" in l for l in lines)


def test_the_run_loads_no_jax_and_the_reference_no_program():
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}]\n"
        "import perfbench.reference.ssm, perfbench.reference.moe\n"
        "import perfbench.reference.common\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'repro', 'repro_torch'))\n"
        "assert not bad, bad\n"
        "from perfbench.tests.test_perfbench_run import tiny_run\n"
        "out = tiny_run('serve-mamba2-130m-s8-closed')\n"
        "assert out['correct']\n"
        "from perfbench.harness.main import forbidden_modules\n"
        "import perfbench.control, perfbench.harness.trace\n"
        "assert 'repro_torch' in sys.modules\n"
        "print(forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "serve-mamba2-130m-s8-closed", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode != 0 and r.stdout == ""


def test_a_task_longer_than_the_planned_one_is_refused():
    """serve plans the cut and the scheduler's packet for tasks of
    ``PLAN_SEQ`` tokens: a longer task would run on a plan for a smaller
    packet than it sends."""
    from perfbench.drivers.served_split import Driver
    from perfbench.harness.served import PLAN_SEQ
    _, conf, traffic, _ = cell_files("serve-mamba2-130m-s8-closed")
    with pytest.raises(ValueError, match="planned for tasks of at most"):
        Driver(tiny_conf(conf), dict(traffic, seq_len=PLAN_SEQ + 1), 5,
               torch.device("cpu"))


@pytest.mark.parametrize("cell", ["serve-mamba2-130m-s8-closed",
                                  "serve-mixtral-8x7b-4l-s8-poisson"])
def test_every_per_layer_reader_reads_a_traced_window(cell):
    """The driver's fields after a tiny window, with a trace of the
    kernels the readers look for: each of the cell's per-layer metrics
    reads a number (host launches read 0 here: on the CPU a jitted
    segment is the bare function and no kernel launches)."""
    import importlib

    from perfbench.drivers.served_split import Driver
    from perfbench.harness import traffic as T
    from perfbench.harness import window as WIN
    _, conf, traffic, _ = cell_files(cell)
    traffic = tiny_traffic(traffic)
    drv = Driver(tiny_conf(conf), traffic, 5, torch.device("cpu"))
    mark = drv.mark()
    w = WIN.run(drv, 5, 0.5, T.due_times(traffic, 0.5), False)
    problem, _, fields = drv.after_window(mark, w["records"], (1, 4))
    assert problem is None
    trace = {"busy_s": 0.02, "window_s": 0.05, "kernels": {
        "row_pass_kernel<8>": (1e-4, 3), "dequant_kernel": (3e-5, 3)}}
    run = MAIN.Run(records=w["records"], window_s=w["t1"] - w["t0"],
                   setup_s=1.0, trace=trace, trace_range=(1, 4), **fields)
    metrics = [m for m in bench()["per_layer"] if MAIN.applies(m, cell)]
    assert metrics
    for m in metrics:
        reader = importlib.import_module(
            f"perfbench.metrics.{m['name'].split('.')[0]}")
        v = reader.read(run)
        assert v is not None and math.isfinite(v), m["name"]
        assert v > 0 or m["name"].startswith("host_launches"), m["name"]
