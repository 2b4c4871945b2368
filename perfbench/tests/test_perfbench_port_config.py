"""How the harness finds the program's model: each configuration file
names the port module that holds it (``module``), and ``port_config``
applies the file's ``model`` over that module's ``CONFIG``.  A model
that the reference's pinned registry lacks enters as a module of its
own, with a ``ModelConfig`` subclass, and new files only."""

import dataclasses
import math
import sys
import time
import types

import pytest
import torch

from perfbench.harness import main as MAIN
from perfbench.harness import weights as W
from perfbench.harness.served import port_config
from perfbench.tests import port_module_fixture as FIX
from perfbench.tests.tiny import (bench, cell_files, on_the_cpu, tiny_conf,
                                  tiny_traffic, tiny_widths)

PIPE = "pipe-qwen3-14b-bf16-2x1x512"


def conf_file(name):
    """The configuration file that ``BENCHMARK.json`` names ``name``,
    as the harness loads it."""
    cell = next(w["name"] for w in bench()["workloads"]
                if w["config"] == name)
    return cell_files(cell)[1]


@pytest.mark.parametrize("name,arch", [
    ("mamba2-130m", "mamba2-130m"),
    ("mixtral-8x7b-4l", "mixtral-8x7b"),
    ("qwen3-14b-bf16", "qwen3-14b")])
def test_each_configuration_gives_what_the_registry_gave(name, arch):
    """The file's module gives, field for field, what the registry's
    ``arch`` gave with the same ``model`` over it."""
    from repro_torch.configs import get_config
    conf = conf_file(name)
    got = port_config(conf)
    want = dataclasses.replace(get_config(arch), **conf["model"])
    assert type(got) is type(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == want


def cpu_run(monkeypatch, cell, conf, traffic, limits, seed=5, seconds=1.0,
            fault=None):
    """A tiny run on one thread, as ``run.py`` runs, with the driver's
    card-only path stood in for."""
    on_the_cpu(limits["driver"], monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return MAIN.execute(bench(), cell, conf, traffic, limits, seed,
                            seconds, False, torch.device("cpu"), time.time(),
                            fault=fault)
    finally:
        torch.set_num_threads(threads)


def tiny_cell(name):
    """A real cell at the tiny widths, its tasks or requests at most 32
    tokens long."""
    cell, conf, traffic, limits = cell_files(name)
    return (cell, tiny_conf(conf),
            tiny_traffic(traffic, min(int(traffic["seq_len"]), 32)), limits)


def test_a_model_outside_the_registry_runs_through_the_pipelined_step(
        monkeypatch):
    """The pipe cell's files, with ``module`` naming the fixture, whose
    ``CONFIG`` has a field of its own that ``model`` sets: the field
    reaches the driver's ``cfg``, and the run is correct."""
    cell, conf, traffic, limits = cell_files(PIPE)
    conf = dict(conf, module=FIX.__name__,
                model=dict(conf["model"], residual_multiplier=0.22))
    seen = []
    out = cpu_run(monkeypatch, cell, tiny_conf(conf),
                  tiny_traffic(traffic, 32), limits,
                  fault=lambda drv: seen.append(drv.cfg))
    lines = out.pop("_lines")
    assert out["correct"] is True, lines
    assert out["failed"] == 0 and out["attempted"] >= 2
    (cfg,) = seen
    assert type(cfg) is FIX.ScaledConfig
    assert cfg.residual_multiplier == 0.22
    assert cfg.d_model == tiny_widths("dense")["d_model"]


class NotAConfig(types.ModuleType):
    CONFIG = {"d_model": 64}


@pytest.mark.parametrize("module,why", [
    ("repro_torch.configs.no_such_model", "does not import"),
    ("repro_torch.models.config", "CONFIG is NoneType"),
    ("perfbench_not_a_config", "CONFIG is dict")])
@pytest.mark.parametrize("cell", ["serve-mamba2-130m-s8-closed", PIPE])
def test_a_module_that_holds_no_config_stops_before_any_weights(
        monkeypatch, module, why, cell):
    monkeypatch.setitem(sys.modules, "perfbench_not_a_config",
                        NotAConfig("perfbench_not_a_config"))
    made = []
    monkeypatch.setattr(W, "make", lambda *a, **k: made.append(a))
    cell_, conf, traffic, limits = tiny_cell(cell)
    conf = dict(conf, module=module)
    with pytest.raises(ValueError) as e:
        cpu_run(monkeypatch, cell_, conf, traffic, limits)
    msg = str(e.value)
    assert conf["file"] in msg and repr(module) in msg and why in msg, msg
    assert made == []


def test_a_model_key_that_the_config_lacks_names_the_file():
    conf = conf_file("qwen3-14b-bf16")
    conf = dict(conf, model=dict(conf["model"], residual_multiplier=0.22))
    with pytest.raises(ValueError, match="residual_multiplier") as e:
        port_config(conf)
    assert "perfbench/configs/qwen3-14b-bf16.json" in str(e.value)
    assert "repro_torch.configs.qwen3_14b" in str(e.value)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_runs_tiny_through_its_own_driver(monkeypatch, cell):
    """Every cell of ``BENCHMARK.json``, a later one too, at the tiny
    widths of its kind, through the driver its cell file names."""
    out = cpu_run(monkeypatch, *tiny_cell(cell))
    lines = out.pop("_lines")
    assert out["correct"] is True, lines
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["checks"]) == set(cell_files(cell)[3]["limits"])


def test_a_kind_without_tiny_widths_names_the_missing_file():
    conf = dict(conf_file("qwen3-14b-bf16"), kind="hybrid")
    with pytest.raises(FileNotFoundError,
                       match="perfbench/tests/tiny_widths/hybrid.json"):
        tiny_conf(conf)


# -------------------------------------------------------------- weights
def parents_fill(name, t, gen):
    """``weights._fill`` as it was before a leaf that no rule covers was
    refused by name: the draws that every existing leaf must keep."""
    if name in W.ONES:
        return t.fill_(1.0)
    if name in W.ZEROS:
        return t.zero_()
    if name == "A_log":
        return t.uniform_(1.0, 16.0, generator=gen).log_()
    if name == "dt_bias":
        t.uniform_(math.log(1e-3), math.log(0.1), generator=gen)
        return t.exp_().expm1_().log_()
    std = W.FIXED_STD.get(name, 1.0 / math.sqrt(t.shape[-2]))
    return t.normal_(0.0, std, generator=gen)


@pytest.mark.parametrize("name", ["mamba2-130m", "mixtral-8x7b-4l",
                                  "qwen3-14b-bf16"])
def test_the_weights_keep_their_draws_and_refuse_an_unknown_vector(
        monkeypatch, name):
    from repro_torch.models import model as M
    conf = tiny_conf(conf_file(name))
    meta = M.init_params(port_config(conf),
                         dtype=getattr(torch, conf["dtype"]), device="meta")
    got = dict(W.leaves(W.make(meta, 2 ** 31 + 7, "cpu")))
    with monkeypatch.context() as m:
        m.setattr(W, "_fill", lambda path, t, gen:
                  parents_fill(path[-1], t, gen))
        want = dict(W.leaves(W.make(meta, 2 ** 31 + 7, "cpu")))
    assert got.keys() == want.keys()
    for path in want:
        assert torch.equal(got[path], want[path]), path
    bad = dict(meta, extra={"gate_bias": torch.empty(8, device="meta")})
    with pytest.raises(ValueError, match="1-D leaf extra/gate_bias"):
        W.make(bad, 1, "cpu")
