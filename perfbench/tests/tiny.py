"""Tiny versions of the benchmark's configurations and cells, for the
CPU tests: the real files with the widths cut so that a run takes
seconds on the host, and the deployment the program's planner gives."""

import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = {
    "ssm": dict(num_layers=4, d_model=64, vocab_size=512, ssm_state=16,
                ssm_head_dim=16, ssm_chunk=16),
    "moe": dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, d_ff=128, vocab_size=512, sliding_window=64),
    "dense": dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=512),
}


def bench():
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def cell_files(name):
    """(cell entry, configuration, traffic, limits) of a real cell."""
    from perfbench.harness.main import load
    _, cell, conf, traffic, limits = load(ROOT, name)
    return cell, conf, traffic, limits


def tiny_conf(conf):
    """``conf`` with the tiny widths and its deployment at them: a
    served split's planner's cut, or two pods of half the layers each."""
    from perfbench.harness.served import deployment, plan, port_config
    from repro_torch.core.costs import WIFI_5GHZ
    conf = copy.deepcopy(conf)
    conf["model"].update(TINY[conf["kind"]])
    if "layers_per_pod" in conf["deployment"]:
        conf["deployment"]["layers_per_pod"] = \
            conf["model"]["num_layers"] // 2
        return conf
    cut, off = plan(port_config(conf), WIFI_5GHZ(50.0))
    conf["deployment"] = deployment(cut, off)
    return conf


def tiny_traffic(traffic, seq_len=None):
    t = dict(traffic)
    if seq_len is not None:
        t["seq_len"] = seq_len
    if t["arrivals"] == "open_poisson":
        t["rate"] = 40.0
    return t
