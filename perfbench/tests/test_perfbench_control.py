"""The control of ``correct`` at a size a test run holds: the reference
put in the program's place, in bfloat16, fails the cell's limits."""

import pytest
import torch

from perfbench.control import control
from perfbench.tests.tiny import bench, cell_files, tiny_conf, tiny_traffic


@pytest.mark.parametrize("cell,seq_len,tasks", [
    ("serve-mamba2-130m-s8-closed", None, 60),
    ("serve-mixtral-8x7b-4l-s8-poisson", None, 0),
    ("serve-mamba2-130m-s128-closed", 32, 60),
    ("serve-mixtral-8x7b-4l-s128-closed", 32, 60)])
def test_bfloat16_control_is_not_correct(cell, seq_len, tasks):
    c, conf, traffic, limits = cell_files(cell)
    numbers, ok, lines = control(bench(), c, tiny_conf(conf),
                                 tiny_traffic(traffic, seq_len), limits, 3,
                                 1.0, tasks, torch.device("cpu"),
                                 "bfloat16")
    assert not ok, lines


def test_each_cell_finds_its_controls_through_its_driver():
    from perfbench.control import controls
    for w in bench()["workloads"]:
        limits = cell_files(w["name"])[3]
        want = {"served_split": {"bfloat16"},
                "pipe_step": {"float8_e4m3fn", "wire4"}}[limits["driver"]]
        assert set(controls(limits)) == want


@pytest.mark.parametrize("cell", ["serve-mamba2-130m-s128-closed",
                                  "pipe-qwen3-14b-bf16-2x1x512"])
def test_a_closed_cell_needs_its_task_count(cell, capsys):
    """A closed cell's control samples as a run of ``--tasks`` tasks
    does; without the count it stops at the arguments and names it."""
    from perfbench.control import main
    with pytest.raises(SystemExit) as e:
        main(["--workload", cell, "--seeds", "1", "--seconds", "20"])
    assert e.value.code == 2
    assert "--tasks" in capsys.readouterr().err
