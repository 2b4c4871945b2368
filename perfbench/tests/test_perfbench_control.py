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
                                 torch.bfloat16)
    assert not ok, lines
