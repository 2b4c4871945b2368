"""The flop formulas against ``torch.utils.flop_counter`` on the plain
reference at a reduced size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.flops import moe as FM
from perfbench.flops import ssm as FS
from perfbench.harness import weights as W
from perfbench.harness.served import port_config
from perfbench.reference import moe as RM
from perfbench.reference import ssm as RS
from perfbench.tests.tiny import cell_files, tiny_conf


def counted(ref, conf, seq_len):
    from repro_torch.models import model as M
    params = W.make(M.init_params(port_config(conf), device="meta"), 7,
                    "cpu")
    model = conf["model"]
    toks = torch.randint(0, model["vocab_size"], (1, seq_len))
    with FlopCounterMode(display=False) as fc:
        ref.forward(params, model, toks, range(model["num_layers"]),
                    first=True, last=True)
    return fc.get_total_flops()


@pytest.mark.parametrize("seq_len", [8, 40])
def test_ssm_flops(seq_len):
    conf = tiny_conf(cell_files("serve-mamba2-130m-s8-closed")[1])
    assert counted(RS, conf, seq_len) == FS.task_flops(conf["model"],
                                                       seq_len)


@pytest.mark.parametrize("seq_len", [8, 40])
def test_moe_flops(seq_len):
    conf = tiny_conf(cell_files("serve-mixtral-8x7b-4l-s8-poisson")[1])
    m = conf["model"]
    # no token over capacity, so every token meets k experts
    m["capacity_factor"] = m["num_experts"] / m["experts_per_token"]
    # the reference scores every key and masks; the formula counts the
    # causal ones
    masked = m["num_layers"] * 4 * m["num_heads"] * m["head_dim"] * (
        seq_len * seq_len - FM.attended(seq_len, m["sliding_window"]))
    assert counted(RM, conf, seq_len) == FM.task_flops(m, seq_len) + masked


def test_full_size_flops_are_the_published_arithmetic():
    """2 x active parameters a token, plus attention and the head."""
    m = cell_files("serve-mixtral-8x7b-4l-s128-closed")[1]["model"]
    per_layer_active = (4096 * (32 + 16) * 128 + 32 * 128 * 4096
                        + 4096 * 8 + 2 * 3 * 4096 * 14336)
    want = 2 * per_layer_active * 512 * 4 \
        + 4 * 4 * 32 * 128 * 512 * 513 // 2 + 2 * 4096 * 32000
    assert FM.task_flops(m, 512) == want
    s = cell_files("serve-mamba2-130m-s128-closed")[1]["model"]
    assert 0.09e12 < FS.task_flops(s, 512) < 0.11e12
